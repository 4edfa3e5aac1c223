"""volume.scrub — trigger a foreground scrub pass across the cluster.

The port's copy of seaweedfs_tpu/shell/command_volume_scrub.py.
Drives the VolumeScrub RPC on every volume server (or the holders of one
``-volumeId``): each server CRC-verifies its live needles and EC shard
intervals at the scrubber's bounded rate and — unless ``-noRepair`` —
repairs corruption in place from replicas or RS(k,m) reconstruction.
The per-volume verdicts print as they arrive; unrepaired corruption also
reaches the master through the next heartbeat (``scrub_corrupt`` on
VolumeStat) and is visible in ``volume.list``-driven tooling and
``/debug/scrub`` on the server.
"""

from __future__ import annotations

import grpc

from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell import shell_command
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr


@shell_command("volume.scrub", "CRC-verify volumes and repair corruption")
def cmd_volume_scrub(env, args, out):
    env.confirm_is_locked()
    topo = env.collect_topology().topology_info
    servers: dict[str, set[int]] = {}  # grpc addr -> vids held
    for dc in topo.data_center_infos:
        for rack in dc.rack_infos:
            for dn in rack.data_node_infos:
                addr = grpc_addr(dn.url, dn.grpc_port)
                vids = servers.setdefault(addr, set())
                for disk in dn.disk_infos.values():
                    vids.update(v.id for v in disk.volume_infos)
                    vids.update(e.volume_id for e in disk.ec_shard_infos)
    targets = [
        addr for addr in sorted(servers)
        if not args.volumeId or args.volumeId in servers[addr]
    ]

    def scrub_one(addr):
        return env.volume(addr).VolumeScrub(
            vs_pb.VolumeScrubRequest(
                volume_id=args.volumeId, repair=not args.noRepair
            )
        )

    # every server scrubs independently at its own rate bound: fan out so
    # a cluster-wide pass takes the slowest server's time, not the sum
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(16, max(1, len(targets)))) as pool:
        futures = {addr: pool.submit(scrub_one, addr) for addr in targets}
    total = dict(scanned=0, corrupt=0, repaired=0, failed=0)
    for addr in targets:
        try:
            resp = futures[addr].result()
        except grpc.RpcError as e:
            print(f"{addr}: scrub failed: {e.details() or e}", file=out)
            continue
        for r in resp.results:
            for k in total:
                total[k] += getattr(r, k)
            if r.corrupt or args.verbose:
                kind = "ec volume" if r.ec else "volume"
                print(
                    f"{addr}: {kind} {r.volume_id}: {r.scanned} scanned, "
                    f"{r.corrupt} corrupt, {r.repaired} repaired"
                    + (f", {r.failed} FAILED" if r.failed else ""),
                    file=out,
                )
    print(
        f"volume.scrub: {total['scanned']} needles verified, "
        f"{total['corrupt']} corrupt, {total['repaired']} repaired, "
        f"{total['failed']} failed"
        + (" (verify only)" if args.noRepair else ""),
        file=out,
    )


def _scrub_flags(p):
    p.add_argument("-volumeId", type=int, default=0, help="limit to one volume")
    p.add_argument(
        "-noRepair", action="store_true",
        help="verify and report only; do not rewrite anything",
    )
    p.add_argument("-verbose", action="store_true", help="print clean volumes too")


cmd_volume_scrub.configure = _scrub_flags
