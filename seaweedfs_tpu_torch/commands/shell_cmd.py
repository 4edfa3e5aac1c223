"""``shell``: cluster orchestration against the port's master.

The port of seaweedfs_tpu/commands/shell_cmd.py (reference `weed shell`,
weed/shell/shell_liner.go): a REPL, or one-shot ``-c "cmd; cmd"``, of the
port's shell commands (seaweedfs_tpu_torch/shell), under the master-leased
admin lock.  ``-filer`` names the filer's gRPC address for the fs.*
commands and ``volume.fsck``.  With ``$TRACEPARENT`` set (a W3C
traceparent, the environment carrier of OpenTelemetry's CLI convention)
each ``-c`` command runs in a ``shell`` span of that trace, so the RPCs it
makes carry the context and the servers' spans join it (``trace.dump``).
"""

from __future__ import annotations

import contextlib
import os
import sys

from seaweedfs_tpu_torch.commands import command


@command("shell", "cluster orchestration shell (lock, ec.encode, ec.rebuild, ...)")
def run(args) -> int:
    from seaweedfs_tpu_torch.shell import ShellError, run_command, split_commands
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    from seaweedfs_tpu_torch.stats import trace

    env = CommandEnv(args.master, filer_grpc_address=args.filer)
    parent = trace.parse_traceparent(os.environ.get("TRACEPARENT"))
    try:
        if args.c:
            for words in split_commands(args.c):
                span = (trace.span(words[0], service="shell", parent=parent)
                        if parent is not None else contextlib.nullcontext())
                try:
                    with span:
                        run_command(env, words)
                except Exception as e:  # noqa: BLE001 — report and fail the run
                    print(f"error: {e}", file=sys.stderr)
                    return 1
            return 0
        while True:
            try:
                line = input("> ")
            except EOFError:
                break
            if line.strip() in ("exit", "quit"):
                break
            try:
                run_command(env, line)
            except ShellError as e:
                print(f"error: {e}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — the REPL must survive
                print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 0
    finally:
        env.release_lock()


def _configure(p):
    p.add_argument("-master", default="127.0.0.1:19333",
                   help="master gRPC address (host:grpc_port), or a comma list of them")
    p.add_argument("-c", default="", help="run `;`-separated commands and exit")
    p.add_argument("-filer", default="",
                   help="filer gRPC address (host:grpc_port) for fs.* commands")


run.configure = _configure
