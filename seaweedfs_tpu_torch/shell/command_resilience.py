"""Resilience inspection shell commands: the port's copy of
seaweedfs_tpu/shell/command_resilience.py.

``resilience.status`` prints the per-peer circuit breaker states and the
active fault-injection plan — this process's own (in-process servers:
tests, ``cli server``) or a remote server's ``/debug/breakers`` +
``/debug/faults`` endpoints when ``-server host:port`` is given.

``fault.inject`` installs/clears a WEED_FAULTS spec in this process —
the operator's handle for rehearsing failures from the shell.
"""

from __future__ import annotations

import json

from seaweedfs_tpu_torch.shell import ShellError, shell_command


def _fetch(server: str, path: str) -> str:
    from seaweedfs_tpu_torch.util.http_pool import shared_pool

    host, _, port = server.rpartition(":")
    if not host or not port.isdigit():
        raise ShellError(f"-server must be host:port, got {server!r}")
    try:
        status, raw = shared_pool().request(server, "GET", path, timeout=10)
    except OSError as e:
        raise ShellError(f"cannot reach {server}: {e}") from e
    body = raw.decode(errors="replace")
    if status != 200:
        raise ShellError(f"{server}{path}: HTTP {status} {body[:200]}")
    return body


@shell_command(
    "resilience.status",
    "per-peer circuit breaker states + the active fault plan",
)
def cmd_resilience_status(env, args, out):
    if args.server:
        breakers = json.loads(_fetch(args.server, "/debug/breakers"))
        plan = json.loads(_fetch(args.server, "/debug/faults"))
    else:
        from seaweedfs_tpu_torch.util import faults, resilience

        breakers = resilience.snapshot()
        plan = faults.snapshot()
    if not breakers:
        print("breakers: none (no peer has been called)", file=out)
    else:
        print(f"breakers ({len(breakers)} peers):", file=out)
        for b in sorted(breakers, key=lambda b: b["peer"]):
            print(
                f"  {b['peer']:<24} {b['state']:<9} "
                f"failures={b['failures']}",
                file=out,
            )
    if not plan.get("active"):
        print("faults: no active plan", file=out)
        return
    print(
        f"faults: seed={plan['seed']} injected={plan['injected']}", file=out
    )
    for r in plan["rules"]:
        print(f"  {r['rule']}  fired={r['fired']}", file=out)


def _status_flags(p):
    p.add_argument(
        "-server", default="",
        help="fetch /debug/breakers + /debug/faults from this host:port "
        "instead of the local process",
    )


cmd_resilience_status.configure = _status_flags


@shell_command(
    "fault.inject",
    "install (or clear) a WEED_FAULTS plan in this process",
)
def cmd_fault_inject(env, args, out):
    from seaweedfs_tpu_torch.util import faults

    if args.clear:
        # pin "no plan" (reset() would fall back to $WEED_FAULTS on next use)
        faults.configure(None)
        print("fault plan cleared", file=out)
        return
    if not args.spec:
        raise ShellError("fault.inject needs -spec or -clear")
    try:
        plan = faults.configure(args.spec, seed=args.seed)
    except faults.FaultSpecError as e:
        raise ShellError(str(e)) from e
    print(
        f"installed {len(plan.rules)} rule(s), seed={plan.seed}:", file=out
    )
    for r in plan.rules:
        print(f"  {r.describe()}", file=out)


def _inject_flags(p):
    p.add_argument(
        "-spec", default="",
        help='WEED_FAULTS spec, e.g. "volume:Read:unavailable:0.5"',
    )
    p.add_argument(
        "-seed", type=int, default=None,
        help="RNG seed (default: $WEED_FAULTS_SEED or 0)",
    )
    p.add_argument("-clear", action="store_true", help="remove the plan")


cmd_fault_inject.configure = _inject_flags
