"""Cluster-orchestration shell (``cli shell``).

The port's copy of seaweedfs_tpu/shell (reference `weed shell`,
weed/shell/commands.go, shell/shell_liner.go): dot-separated cluster
commands running against the master under a cluster-exclusive admin
lock.  Commands self-register via @shell_command; the REPL and one-shot
``-c`` runner both dispatch through ``run_command``.  Ported commands:
``lock``, ``unlock``, ``help``, ``ec.encode``, ``ec.balance``,
``ec.rebuild``, ``ec.decode``, ``cluster.ps``, ``cluster.check``,
``cluster.raft.ps``, ``cluster.raft.add``, ``cluster.raft.remove``,
``volume.list``, ``collection.list``, ``collection.delete``,
``volume.vacuum``, ``volume.delete``, ``volume.mark``, ``volume.copy``,
``volume.move``, ``volume.mount``, ``volume.unmount``, ``volume.grow``,
``volume.configure.replication``, ``volume.fix.replication``,
``volume.deleteEmpty``, ``volume.server.evacuate``,
``volume.server.leave``, ``volume.tier.move``, ``volume.balance``,
``volume.check.disk``, ``volume.scrub``, ``volume.repair.status``,
``volume.fsck`` and the fs.* commands (``fs.cd``, ``fs.pwd``, ``fs.ls``,
``fs.tree``, ``fs.du``, ``fs.cat``, ``fs.mkdir``, ``fs.mv``, ``fs.rm``,
``fs.meta.save``, ``fs.meta.load``, ``fs.meta.cat``, ``fs.log``,
``fs.verify``, ``fs.configure``) and the s3.* commands (``s3.bucket.list``,
``s3.bucket.create``, ``s3.bucket.delete``, ``s3.bucket.quota``,
``s3.bucket.quota.check``, ``s3.clean.uploads``, ``s3.circuitbreaker``,
``s3.qos``, ``s3.configure``) and ``filer.shard.status`` against the
shell's ``-filer`` (a comma list of filers rides the shard router), and the observability commands (``trace.dump``,
``resilience.status``, ``fault.inject``, ``slo.status``,
``cluster.status``, ``events.dump``), which read this process or the
``/debug/`` pages of the members they are given, and the remote-storage
commands (``remote.mount``, ``remote.meta.sync``, ``remote.cache``,
``remote.uncache``, ``remote.unmount``) against their own ``-filer``, and
the message queue's (``mq.topic.list``, ``mq.topic.desc``,
``mq.topic.configure``, ``mq.topic.compact``, ``mq.balance``,
``mq.group.desc``) against the brokers the master lists.  The
shell runs no kernel and takes no device: the EC work happens inside the
volume servers it drives."""

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
        command_filer_shard,
        command_fs,
        command_mq,
        command_remote,
        command_resilience,
        command_s3,
        command_slo,
        command_trace,
        command_volume,
        command_volume_balance,
        command_volume_check,
        command_volume_ops,
        command_volume_repair,
        command_volume_scrub,
    )


_import_all()
