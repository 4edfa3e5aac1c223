"""Cluster-orchestration shell (``cli shell``).

The port's copy of seaweedfs_tpu/shell (reference `weed shell`,
weed/shell/commands.go, shell/shell_liner.go): dot-separated cluster
commands running against the master under a cluster-exclusive admin
lock.  Commands self-register via @shell_command; the REPL and one-shot
``-c`` runner both dispatch through ``run_command``.  Ported commands:
``lock``, ``unlock``, ``help``, ``ec.encode``, ``ec.balance``,
``ec.rebuild``, ``ec.decode``, ``cluster.ps``, ``cluster.check``,
``cluster.raft.ps``, ``cluster.raft.add`` and ``cluster.raft.remove``.  The shell runs no kernel and takes no
device: the EC work happens inside the volume servers it drives."""

from __future__ import annotations

import argparse
import shlex
import sys
from dataclasses import dataclass
from typing import Callable, TextIO

from seaweedfs_tpu_torch.shell.command_env import CommandEnv

SHELL_REGISTRY: dict[str, "ShellCommand"] = {}


@dataclass
class ShellCommand:
    name: str
    help: str
    run: Callable  # (env, args: argparse.Namespace, out: TextIO) -> None
    configure: Callable[[argparse.ArgumentParser], None]


def shell_command(name: str, help: str):
    """Register a shell command; attach flag setup via fn.configure."""

    def wrap(fn):
        SHELL_REGISTRY[name] = ShellCommand(
            name=name,
            help=help,
            run=fn,
            configure=lambda p: getattr(fn, "configure", lambda _: None)(p),
        )
        return fn

    return wrap


class ShellError(Exception):
    pass


def split_commands(text: str) -> list[list[str]]:
    """Split a `;`-separated command string into word lists, honoring
    quotes (a ';' inside a quoted argument is literal)."""
    lex = shlex.shlex(text, posix=True, punctuation_chars=";")
    lex.whitespace_split = True
    groups: list[list[str]] = []
    cur: list[str] = []
    for tok in lex:
        if tok == ";":
            if cur:
                groups.append(cur)
                cur = []
        else:
            cur.append(tok)
    if cur:
        groups.append(cur)
    return groups


def run_command(
    env: CommandEnv, line: str | list[str], out: TextIO = sys.stdout
) -> None:
    """Parse and run one shell line, e.g. `ec.encode -volumeId 3`.

    Flags use the reference's single-dash style (-volumeId); argparse
    accepts them via the aliases each command registers."""
    words = shlex.split(line, comments=True) if isinstance(line, str) else line
    if not words:
        return
    name, argv = words[0], words[1:]
    cmd = SHELL_REGISTRY.get(name)
    if cmd is None:
        raise ShellError(
            f"unknown command {name!r} (try `help`)"
        )
    parser = argparse.ArgumentParser(prog=name, add_help=False)
    cmd.configure(parser)
    try:
        args = parser.parse_args(argv)
    except SystemExit:
        raise ShellError(f"bad arguments for {name}: {argv!r}") from None
    cmd.run(env, args, out)


def _import_all() -> None:
    from seaweedfs_tpu_torch.shell import (  # noqa: F401
        command_cluster,
        command_ec,
        command_ec_balance,
        command_volume,
    )


_import_all()
