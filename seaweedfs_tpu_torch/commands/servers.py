"""``master`` and ``volume``: run the port's master and volume server.

The port of seaweedfs_tpu/commands/servers.py's ``master`` and ``volume``
commands.  ``master`` takes ``-ip``, ``-port`` (its HTTP endpoints; 0
binds a free port), ``-grpcPort`` (default ``-port`` + 10000; with
``-port 0``, a free port), ``-volumeSizeLimitMB``, ``-defaultReplication``,
``-jwtKey`` and, for HA, ``-peers`` (every master's ``ip:port``, itself
included), ``-mdir`` (durable sequence state, and the raft log) and ``-ha``
(``lease``, the default, or ``raft``, which needs ``-mdir``; with
``-ha raft`` an empty ``-peers`` starts a passive joiner for
``cluster.raft.add``); it runs no kernel and takes no device.  ``volume``
takes ``-dir``, ``-mserver`` (the master's gRPC address, or a
comma-separated list of them; the port's default is none: no heartbeat),
``-ip``, ``-port`` (the HTTP needle API; ``ip:port`` names the node at the
master), ``-grpcPort`` (as the master's), ``-publicUrl`` (the read address
advertised; default ``ip:port``), ``-dataCenter``, ``-rack``, ``-max``
(volumes per dir), ``-jwtKey``, ``-fsync`` (default ``$WEED_FSYNC`` or
``close``), ``-index`` (needle map: ``memory``, ``compact`` or
``leveldb``), ``-backend`` (``.dat`` storage: ``disk``, ``mmap`` or
``memory``), ``-offsetWidth`` (4 or 5 index offset bytes for new
volumes), ``-metricsPort`` (a separate ``/metrics``
listener; 0 picks a free port, none when left out) and ``-device``
(default ``cuda``; ``cpu`` runs the codec on the host).  Each prints one
first line on stdout that names the ports it bound.  The volume server
resolves its device at start: without CUDA, and without ``-device cpu``,
it raises and exits.  SIGINT or SIGTERM stops either.
"""

from __future__ import annotations

import signal
import threading

from seaweedfs_tpu_torch.commands import command


def _wait_forever() -> int:
    """Block until SIGINT/SIGTERM; returns the signal number that fired."""
    stop = threading.Event()
    fired = [0]

    def handler(signum, _frame):
        fired[0] = signum
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, handler)
    stop.wait()
    return fired[0]


@command("master", "run a master (topology, heartbeats, assigns, EC lookups, admin lock, HA)")
def run_master(args) -> int:
    from seaweedfs_tpu_torch.server.master_server import MasterServer

    ms = MasterServer(ip=args.ip, port=args.port, grpc_port=args.grpcPort,
                      volume_size_limit_mb=args.volumeSizeLimitMB,
                      default_replication=args.defaultReplication,
                      peers=[p.strip() for p in args.peers.split(",") if p.strip()],
                      meta_dir=args.mdir, ha=args.ha, jwt_key=args.jwtKey)
    ms.start()
    print(f"master gRPC on {ms.grpc_address}, HTTP on {ms.advertise}", flush=True)
    try:
        _wait_forever()
    finally:
        ms.stop()
    return 0


def _master_flags(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-grpcPort", type=int, default=0, help="default port+10000")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-peers", default="", help="comma list of all master ip:port (incl. self)")
    p.add_argument("-mdir", default="", help="meta dir for durable master state")
    p.add_argument("-ha", default="lease", choices=("lease", "raft"),
                   help="HA mode: lease probing or raft consensus (needs -mdir; "
                   "empty -peers joins passively via cluster.raft.add)")
    p.add_argument("-jwtKey", default="", help="sign per-fid write JWTs (or WEED_JWT_KEY)")


run_master.configure = _master_flags


@command("volume", "run a volume server (HTTP needle API, EC shard service, heartbeats)")
def run_volume(args) -> int:
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    dirs = args.dir.split(",")
    vs = VolumeServer(
        dirs,
        args.mserver,
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpcPort,
        public_url=args.publicUrl,
        metrics_port=args.metricsPort,
        device=args.device,
        data_center=args.dataCenter,
        rack=args.rack,
        max_volume_counts=[args.max] * len(dirs),
        jwt_key=args.jwtKey,
        fsync=args.fsync,
        disk_types=[t.strip() or "hdd" for t in args.disk.split(",")] if args.disk else None,
        scrub_interval_s=args.scrubInterval,
        scrub_rate_mb_s=args.scrubRateMB,
        vacuum_interval_s=args.vacuumInterval,
        vacuum_garbage=args.vacuumGarbage,
        needle_map_kind=args.index,
        backend_kind=args.backend,
        offset_width=args.offsetWidth,
    )
    vs.start()
    metrics = f", metrics on {vs.ip}:{vs.metrics_port}" if vs.metrics_port is not None else ""
    print(f"volume server HTTP on {vs.url}, gRPC on {vs.ip}:{vs.grpc_port} (device {vs.device})"
          f"{metrics}", flush=True)
    try:
        _wait_forever()
    finally:
        vs.stop()
    return 0


def _volume_flags(p) -> None:
    p.add_argument("-dir", default="./data", help="comma-separated data dirs")
    p.add_argument("-mserver", default="",
                   help="master gRPC address, or a comma list of them (none: no heartbeat)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-grpcPort", type=int, default=0, help="default port+10000")
    p.add_argument("-publicUrl", default="")
    p.add_argument("-dataCenter", default="DefaultDataCenter")
    p.add_argument("-rack", default="DefaultRack")
    p.add_argument("-max", type=int, default=8, help="max volumes per dir")
    p.add_argument("-disk", default="",
                   help="comma list of disk types per -dir entry (hdd|ssd|...; default hdd)")
    p.add_argument("-jwtKey", default="", help="verify per-fid write JWTs (or WEED_JWT_KEY)")
    p.add_argument("-index", default="memory", choices=["memory", "compact", "leveldb"],
                   help="needle map kind (leveldb persists beside each .idx)")
    p.add_argument("-backend", default="disk", choices=["disk", "mmap", "memory"],
                   help="volume .dat storage backend")
    p.add_argument("-offsetWidth", type=int, default=4, choices=[4, 5],
                   help="index offset bytes for NEW volumes: 4 = 32GB volume cap "
                   "(reference-interoperable), 5 = 8TB (reference 5BytesOffset build)")
    p.add_argument("-fsync", default="",
                   help="volume fsync policy: always | interval[:N] | close | never "
                   "(default $WEED_FSYNC or close)")
    p.add_argument("-scrubInterval", type=float, default=None,
                   help="seconds between background scrub passes; 0 disables them "
                   "(default $WEED_SCRUB_INTERVAL or 600)")
    p.add_argument("-scrubRateMB", type=float, default=None,
                   help="scrub read-rate bound in MB/s; 0 means unthrottled "
                   "(default $WEED_SCRUB_RATE_MB or 32)")
    p.add_argument("-vacuumInterval", type=float, default=None,
                   help="seconds between auto-vacuum passes; 0 disables them "
                   "(default $WEED_VACUUM_INTERVAL_S or 0)")
    p.add_argument("-vacuumGarbage", type=float, default=None,
                   help="garbage ratio that triggers compaction "
                   "(default $WEED_VACUUM_GARBAGE or 0.3)")
    p.add_argument("-metricsPort", type=int, default=None,
                   help="/metrics listener port (0: a free one; none when left out)")
    p.add_argument("-device", default="cuda",
                   help="codec device: cuda (default; raises without a GPU) or cpu")


run_volume.configure = _volume_flags
