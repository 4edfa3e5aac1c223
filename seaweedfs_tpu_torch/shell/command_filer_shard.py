"""filer.shard.status — the sharded metadata plane at a glance.

Shows the consistent-hash ring (filer/shard_ring.py) over the shell's
configured filer list: per-shard liveness, entry/directory counts, hash
-space ownership share, and where a few well-known prefixes route — the
operator's answer to "which shard owns this bucket, and is it alive".
Run the shell with ``-filer shard1:port,shard2:port,...`` (the same
comma list the gateways take) or pass ``-filer`` to the command.
The port's copy of seaweedfs_tpu/shell/command_filer_shard.py.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.shell import shell_command


@shell_command(
    "filer.shard.status", "shard ring membership, liveness and ownership"
)
def cmd_filer_shard_status(env, args, out):
    from seaweedfs_tpu_torch.filer.shard_ring import ShardedFilerClient
    from seaweedfs_tpu_torch.wdclient import MasterClient

    spec = args.filer or env.filer_address
    if not spec:
        raise RuntimeError(
            "filer.shard.status: no filer configured (shell -filer "
            "host:port,host:port or the command's -filer flag)"
        )
    addrs = [a.strip() for a in spec.split(",") if a.strip()]
    router = ShardedFilerClient(addrs, MasterClient(env.master_address))
    try:
        status = router.shard_status()
        files = dirs = 0
        dead = 0
        print(f"shard ring: {len(addrs)} shard(s), depth {router.depth}", file=out)
        for addr in router.shard_addresses:
            row = status.get(addr, {})
            share = row.get("share", 0.0)
            if row.get("alive"):
                files += row.get("files", 0)
                dirs += row.get("dirs", 0)
                print(
                    f"  {addr}: alive  share={share:.1%}  "
                    f"files={row.get('files', 0)}  dirs={row.get('dirs', 0)}",
                    file=out,
                )
            else:
                dead += 1
                print(
                    f"  {addr}: DEAD   share={share:.1%}  "
                    f"({row.get('error', 'unreachable')})",
                    file=out,
                )
        print(f"  total: files={files} dirs={dirs}", file=out)
        if dead:
            print(
                f"  WARNING: {dead} shard(s) down — ~{dead / len(addrs):.0%} "
                "of prefixes shed with 503 until they return",
                file=out,
            )
        if args.route:
            for p in args.route.split(","):
                p = p.strip()
                if p:
                    print(
                        f"  route {p!r} -> "
                        f"{router.ring.shard_for(p, router.depth)}",
                        file=out,
                    )
    finally:
        router.close()


def _shard_status_flags(p):
    p.add_argument(
        "-filer", default="",
        help="comma-separated shard gRPC addresses (defaults to the "
        "shell's -filer)",
    )
    p.add_argument(
        "-route", default="",
        help="comma-separated paths to show ring routing for",
    )


cmd_filer_shard_status.configure = _shard_status_flags
