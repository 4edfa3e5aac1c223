"""``shell``: cluster orchestration against the port's master.

The port of seaweedfs_tpu/commands/shell_cmd.py (reference `weed shell`,
weed/shell/shell_liner.go): a REPL, or one-shot ``-c "cmd; cmd"``, of the
port's shell commands (seaweedfs_tpu_torch/shell), under the master-leased
admin lock.  ``-filer`` is not ported (no fs.* commands).
"""

from __future__ import annotations

import sys

from seaweedfs_tpu_torch.commands import command


@command("shell", "cluster orchestration shell (lock, ec.encode, ec.rebuild, ...)")
def run(args) -> int:
    from seaweedfs_tpu_torch.shell import ShellError, run_command, split_commands
    from seaweedfs_tpu_torch.shell.command_env import CommandEnv

    env = CommandEnv(args.master)
    try:
        if args.c:
            for words in split_commands(args.c):
                try:
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


run.configure = _configure
