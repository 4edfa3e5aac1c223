"""volume.repair.status — cluster view of repair traffic and its budget.

The port's copy of seaweedfs_tpu/shell/command_volume_repair.py.
Polls every volume server's ``/debug/repair`` endpoint (the
ops/repair_budget snapshot: WEED_REPAIR_RATE_MB token-bucket state plus
the server's ``weedtpu_repair_bytes_total{code,mode,dir}`` /
``weedtpu_repair_ops_total`` series) and prints a per-server and
aggregate summary — the operator's answer to "how much is recovery
moving right now, and is the budget holding".  The RS-vs-LRC split is
the headline column: single-loss LRC repairs should show roughly half
the read bytes per repaired byte of their RS peers (ROBUSTNESS.md,
"Storage classes").
"""

from __future__ import annotations

import json
import re

from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.util.http_pool import shared_pool


_SERIES = re.compile(r"(\w+)=([^,}]+)")


def _labels(key: str) -> dict:
    return dict(_SERIES.findall(key))


@shell_command(
    "volume.repair.status", "repair traffic + bandwidth budget per server"
)
def cmd_volume_repair_status(env, args, out):
    topo = env.collect_topology().topology_info
    urls = sorted(
        {
            dn.url
            for dc in topo.data_center_infos
            for rack in dc.rack_infos
            for dn in rack.data_node_infos
        }
    )
    totals: dict[tuple[str, str, str], float] = {}
    waited = 0.0
    for url in urls:
        try:
            status, body = shared_pool().request(
                url, "GET", "/debug/repair", timeout=5.0
            )
            if status != 200:
                raise IOError(f"HTTP {status}")
            snap = json.loads(body)
        except Exception as e:  # noqa: BLE001 — a dead server is a report line
            print(f"{url}: unreachable ({e})", file=out)
            continue
        rate = snap.get("rate_mb_s", 0.0)
        server_waited = snap.get("waited_s", 0.0)
        waited += server_waited
        line = (
            f"{url}: budget "
            + (f"{rate:g} MB/s" if rate else "unlimited")
            + (f", waited {server_waited:.1f}s" if server_waited else "")
        )
        rows = []
        for key, val in sorted(snap.get("bytes", {}).items()):
            lb = _labels(key)
            triple = (
                lb.get("code", "?"), lb.get("mode", "?"), lb.get("dir", "?")
            )
            totals[triple] = totals.get(triple, 0.0) + val
            rows.append(f"{triple[0]}/{triple[1]}/{triple[2]}={val:g}")
        if rows and args.verbose:
            line += "  [" + " ".join(rows) + "]"
        print(line, file=out)
    if not totals:
        print("volume.repair.status: no repair traffic recorded", file=out)
        return
    print("-- cluster repair bytes by code/mode --", file=out)
    by_cm: dict[tuple[str, str], dict[str, float]] = {}
    for (code, mode, dirn), val in totals.items():
        by_cm.setdefault((code, mode), {})[dirn] = val
    for (code, mode), dirs in sorted(by_cm.items()):
        print(
            f"  {code:>6} {mode:<8} read {dirs.get('read', 0.0):>14g}  "
            f"moved {dirs.get('moved', 0.0):>14g}",
            file=out,
        )
    if waited:
        print(f"  budget throttling absorbed {waited:.1f}s total", file=out)


def _repair_status_flags(p):
    p.add_argument(
        "-verbose", action="store_true",
        help="per-server label-series breakdown, not just the aggregate",
    )


cmd_volume_repair_status.configure = _repair_status_flags
