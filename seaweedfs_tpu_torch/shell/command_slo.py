"""Observability shell commands: the port's copy of
seaweedfs_tpu/shell/command_slo.py.

``slo.status`` evaluates the declarative SLO spec (util/slo.py) against
this process — or a remote server's ``/debug/sloz`` — and prints the
per-rule pass/fail table with margins.

``cluster.status`` scrapes every member's ``/metrics`` + sketch dump +
event ring (stats/cluster_agg.py), merges the latency sketches, and
prints cluster-wide per-op-class p99s, breaker states, plane byte
rates, and cache hit rates.

``events.dump`` prints the flight-recorder ring (stats/events.py) of
this process, one remote server, or the merged time-ordered timeline
across ``-members``.
"""

from __future__ import annotations

import json
import os
import urllib.parse

from seaweedfs_tpu_torch.shell import ShellError, shell_command
from seaweedfs_tpu_torch.shell.command_resilience import _fetch


def _member_list(arg: str) -> list[str]:
    raw = arg or os.environ.get("WEED_CLUSTER_MEMBERS", "")
    members = [m.strip() for m in raw.split(",") if m.strip()]
    if not members:
        raise ShellError(
            "no members: pass -members host:port,... or set "
            "WEED_CLUSTER_MEMBERS"
        )
    return members


@shell_command(
    "slo.status",
    "evaluate the SLO spec against this process or a remote /debug/sloz",
)
def cmd_slo_status(env, args, out):
    from seaweedfs_tpu_torch.util import slo

    if args.server:
        path = "/debug/sloz?cumulative=1"
        if args.spec:
            path += "&spec=" + urllib.parse.quote(args.spec)
        if args.json:
            path += "&json=1"
        print(_fetch(args.server, path).rstrip("\n"), file=out)
        if args.artifacts:
            written = slo.dump_artifacts(
                args.artifacts,
                members=[m.strip() for m in
                         (args.members or args.server).split(",")
                         if m.strip()],
            )
            print(f"artifacts: {len(written)} file(s) in "
                  f"{args.artifacts}", file=out)
        return
    try:
        spec = slo.SloSpec.from_json(args.spec) if args.spec \
            else slo.SloSpec.from_env()
    except slo.SloSpecError as e:
        raise ShellError(str(e)) from e
    if spec is None:
        raise ShellError("no SLO spec: pass -spec or set WEED_SLO")
    report = slo.evaluate_process(spec)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2), file=out)
    else:
        print(report.render_text().rstrip("\n"), file=out)
    if args.artifacts:
        written = slo.dump_artifacts(
            args.artifacts,
            members=[m.strip() for m in args.members.split(",")
                     if m.strip()],
            report=report,
        )
        print(f"artifacts: {len(written)} file(s) in {args.artifacts}",
              file=out)


def _slo_flags(p):
    p.add_argument(
        "-server", default="",
        help="evaluate on this host:port via /debug/sloz instead of locally",
    )
    p.add_argument(
        "-spec", default="",
        help="SLO spec JSON (or @/path/to/spec.json); default $WEED_SLO",
    )
    p.add_argument(
        "-artifacts", default="",
        help="dump forensic artifacts (events + sketches + repair + "
        "breakers) into this directory",
    )
    p.add_argument(
        "-members", default="",
        help="also capture artifacts from these comma-separated "
        "host:port metrics endpoints",
    )
    p.add_argument("-json", action="store_true", help="emit JSON")


cmd_slo_status.configure = _slo_flags


@shell_command(
    "cluster.status",
    "merged cluster view: per-op-class p99s, breakers, planes, caches",
)
def cmd_cluster_status(env, args, out):
    from seaweedfs_tpu_torch.stats import cluster_agg

    members = _member_list(args.members)
    view = cluster_agg.ClusterAggregator(
        members, timeout=args.timeout
    ).scrape()
    if args.json:
        print(json.dumps(view.to_dict(), indent=2), file=out)
    else:
        print(view.render_text().rstrip("\n"), file=out)


def _cluster_flags(p):
    p.add_argument(
        "-members", default="",
        help="comma-separated host:port metrics endpoints "
        "(default $WEED_CLUSTER_MEMBERS)",
    )
    p.add_argument(
        "-timeout", type=float, default=5.0, help="per-member scrape timeout"
    )
    p.add_argument("-json", action="store_true", help="emit JSON")


cmd_cluster_status.configure = _cluster_flags


@shell_command(
    "events.dump",
    "flight-recorder events: local ring, one server, or merged -members",
)
def cmd_events_dump(env, args, out):
    from seaweedfs_tpu_torch.stats import events

    if args.kind and args.kind not in events.KINDS:
        raise ShellError(
            f"unknown kind {args.kind!r}; one of {sorted(events.KINDS)}"
        )
    qs = f"?json=1&limit={args.limit}"
    if args.kind:
        qs += "&kind=" + urllib.parse.quote(args.kind)
    if args.members:
        timelines = [
            (m, json.loads(_fetch(m, "/debug/eventz" + qs)))
            for m in _member_list(args.members)
        ]
        evs = events.merge_timelines(timelines)
    elif args.server:
        evs = json.loads(_fetch(args.server, "/debug/eventz" + qs))
    else:
        evs = events.default_ring.to_dicts(
            kind=args.kind or None, limit=args.limit
        )
    if args.json:
        print(json.dumps({"events": evs}, indent=2), file=out)
        return
    if not evs:
        print("events: none", file=out)
        return
    for ev in evs:
        member = f" {ev['member']}" if "member" in ev else ""
        attrs = " ".join(
            f"{k}={ev[k]}"
            for k in sorted(ev)
            if k not in ("ts", "seq", "kind", "member")
        )
        print(f"  {ev['ts']:.3f}{member} #{ev['seq']:<6} "
              f"{ev['kind']:<24} {attrs}", file=out)


def _events_flags(p):
    p.add_argument(
        "-server", default="",
        help="dump a remote host:port ring via /debug/eventz",
    )
    p.add_argument(
        "-members", default="",
        help="merge rings across comma-separated host:port members "
        "(default $WEED_CLUSTER_MEMBERS when flag given empty is an error)",
    )
    p.add_argument("-kind", default="", help="filter to one event kind")
    p.add_argument(
        "-limit", type=int, default=100, help="newest N events (0 = all)"
    )
    p.add_argument("-json", action="store_true", help="emit JSON")


cmd_events_dump.configure = _events_flags
