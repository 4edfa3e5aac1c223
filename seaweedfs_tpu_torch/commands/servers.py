"""``master``, ``volume``, ``filer``, ``s3`` and ``server``: run the port's
master, volume server, filer and S3 gateway, apart or in one process.

The port of seaweedfs_tpu/commands/servers.py's ``master``, ``volume``,
``filer``, ``s3`` and ``server`` commands.  ``master`` takes ``-ip``, ``-port`` (its HTTP endpoints; 0
binds a free port), ``-grpcPort`` (default ``-port`` + 10000; with
``-port 0``, a free port), ``-volumeSizeLimitMB``, ``-defaultReplication``,
``-jwtKey`` and, for HA, ``-peers`` (every master's ``ip:port``, itself
included), ``-mdir`` (durable sequence state, and the raft log) and ``-ha``
(``lease``, the default, or ``raft``, which needs ``-mdir``; with
``-ha raft`` an empty ``-peers`` starts a passive joiner for
``cluster.raft.add``) and ``-metricsPort`` (0: none); it runs no kernel and
takes no device.  ``volume``
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
it raises and exits.  ``filer`` takes ``-master``, ``-ip``, ``-port``,
``-grpcPort``, ``-db`` (the store: filer.make_store), ``-maxMB`` (the chunk
size), ``-metricsPort`` (0: none), ``-metaLogDir`` and ``-tlsCert``/``-tlsKey``
(HTTPS on its HTTP port) and ``-notify`` (a metadata event bus:
replication/notification.make_bus); it runs no kernel and takes no device.  ``s3`` runs the S3 gateway in one process: over an
embedded filer, or with ``-filer`` (one filer's gRPC address) over
``RemoteFiler`` and the metadata subscriber; it takes ``-master``,
``-ip``, ``-port`` (0 binds a free port), ``-accessKey``/``-secretKey``
(SigV4 and V2 required), ``-kmsKeyFile`` or ``-kms`` (SSE-S3),
``-cacheMB`` (the hot-chunk cache), ``-circuitBreakerFile``, ``-qosFile``,
``-accessLog``, ``-lifecycleSweepSec``, ``-metricsPort``, ``-reusePort`` and
``-tlsCert``/``-tlsKey`` (HTTPS); it runs no kernel and takes no device.
A comma list in ``-filer`` shards the namespace over those filers
(``ShardedFilerClient``); ``-workers N`` forks N gateway processes on one
fixed ``-port`` (SO_REUSEPORT), each with ``-metricsPort`` + i, their
caches kept coherent by the invalidation bus, and refuses ``-port 0`` or
a missing ``-filer`` with exit code 2.
``server`` runs a master, one volume server (its ``-device`` as
``volume``'s) and, with ``-filer``, a filer, and with ``-s3`` a gateway over
that filer, in one process (``-tlsCert``/``-tlsKey`` put the filer's and
the gateway's HTTP ports behind TLS), and with ``-webdav`` a WebDAV gateway
over that filer on ``-webdavPort``.
SIGINT or SIGTERM stops any of them.

Every process honours the environment as the JAX package's do:
``WEEDTPU_TLS_CA``/``_CERT``/``_KEY`` (mutual TLS on every gRPC hop;
``tls.gen`` mints them), ``WEED_FAULTS``/``WEED_FAULTS_SEED`` (fault
injection), ``WEED_SLO`` (the /debug/sloz spec), ``SEAWEEDFS_TPU_TRACE``
(0 stops recording spans), ``SEAWEEDFS_TPU_NATIVE_DP``/``_PX`` (0 runs the
volume server's front door or the gateways' splice in Python) and
``WEED_DRAIN_S`` (how long a SIGTERMed volume server lets the requests in
flight finish, default 5).
"""

from __future__ import annotations

import os
import signal
import sys
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


def _drain_s(sig: int) -> float:
    """Drain budget of a daemon's teardown: SIGTERM is the orchestrated
    restart (finish the requests in flight, ``$WEED_DRAIN_S`` seconds,
    default 5); SIGINT stays an immediate exit, as in the JAX package."""
    if sig != signal.SIGTERM:
        return 0.0
    try:
        return float(os.environ.get("WEED_DRAIN_S", "5") or 0)
    except ValueError:
        return 5.0


@command("master", "run a master (topology, heartbeats, assigns, EC lookups, admin lock, HA)")
def run_master(args) -> int:
    from seaweedfs_tpu_torch.server.master_server import MasterServer

    ms = MasterServer(ip=args.ip, port=args.port, grpc_port=args.grpcPort,
                      volume_size_limit_mb=args.volumeSizeLimitMB,
                      default_replication=args.defaultReplication,
                      peers=[p.strip() for p in args.peers.split(",") if p.strip()],
                      meta_dir=args.mdir, ha=args.ha, jwt_key=args.jwtKey,
                      telemetry_url=args.telemetryUrl,
                      telemetry_interval=args.telemetryInterval)
    ms.start()
    if args.metricsPort:
        from seaweedfs_tpu_torch import stats

        stats.start_metrics_server(args.metricsPort, args.ip)
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
    p.add_argument("-telemetryUrl", default="",
                   help="opt-in: leader POSTs cluster stats here periodically")
    p.add_argument("-telemetryInterval", type=float, default=300.0,
                   help="seconds between telemetry reports")
    p.add_argument("-metricsPort", type=int, default=0,
                   help="standalone Prometheus /metrics + /debug listener (0: none)")


run_master.configure = _master_flags


def _tls_flags(p) -> None:
    p.add_argument("-tlsCert", default="", help="serve HTTPS with this cert")
    p.add_argument("-tlsKey", default="", help="key for -tlsCert")


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
    sig = 0
    try:
        sig = _wait_forever()
    finally:
        vs.stop(drain_s=_drain_s(sig))
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


@command("filer", "run a filer (path metadata + chunked file) server")
def run_filer(args) -> int:
    from seaweedfs_tpu_torch.server.filer_server import FilerServer

    fs = FilerServer(
        args.master,
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpcPort,
        store_path=args.db or None,
        chunk_size=args.maxMB * 1024 * 1024,
        meta_log_dir=args.metaLogDir or None,
        tls_cert=args.tlsCert,
        tls_key=args.tlsKey,
        notify=args.notify,
    )
    fs.start()
    if args.metricsPort:
        from seaweedfs_tpu_torch import stats

        stats.start_metrics_server(args.metricsPort, args.ip)
    print(f"filer on {fs.url} (gRPC {fs.grpc_address}, store={fs.filer.store.name})",
          flush=True)
    try:
        _wait_forever()
    finally:
        fs.stop()
    return 0


def _filer_flags(p) -> None:
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-grpcPort", type=int, default=0, help="default port+10000")
    p.add_argument("-db", default="",
                   help="store: *.db = sqlite, sqlite2:F, directory = LSM, leveldb2:D, "
                   "leveldb3:D, btree:F or *.btree, mysql://u:p@h/db, postgres://u:p@h/db, "
                   "redis://host:port/0, etcd://host:port (default: in-memory)")
    p.add_argument("-maxMB", type=int, default=4, help="chunk size in MiB")
    p.add_argument("-metricsPort", type=int, default=0, help="Prometheus /metrics")
    p.add_argument("-metaLogDir", default="", help="persist the metadata event log here")
    p.add_argument("-notify", default="",
                   help="publish metadata events to a bus: log:/path, webhook:http://..., "
                   "mq://broker:port/topic, kafka://... , sqs:...")
    _tls_flags(p)


run_filer.configure = _filer_flags


@command("s3", "run an S3-compatible gateway over the filer")
def run_s3(args) -> int:
    if args.workers > 1:
        return _run_s3_workers(args)
    return _run_s3_single(args)


def _run_s3_workers(args) -> int:
    """Fork -workers gateway processes sharing the listen address via
    SO_REUSEPORT (the kernel spreads accepted connections across them),
    each with its own FidPool + entry cache, coherent through the
    filer/inval_bus.py worker-group invalidation channel.  The parent
    imports nothing that touches CUDA before it forks (the gateway runs
    no kernel)."""
    import os

    from seaweedfs_tpu_torch.filer.inval_bus import InvalBus

    if args.port == 0:
        print(
            "s3: -workers needs a fixed -port "
            "(SO_REUSEPORT workers share one listen address)",
            file=sys.stderr,
        )
        return 2
    if not args.filer:
        print(
            "s3: -workers needs -filer — each worker is a separate "
            "process, and an embedded filer would give every worker its "
            "own private namespace",
            file=sys.stderr,
        )
        return 2
    # bind every worker's bus endpoint BEFORE forking so each child
    # knows the full peer list with no discovery protocol
    socks = InvalBus.group(args.workers)
    ports = [s.getsockname()[1] for s in socks]
    sys.stdout.flush()
    sys.stderr.flush()
    pids: list[int] = []
    for i in range(args.workers):
        pid = os.fork()
        if pid == 0:  # worker
            rc = 1
            try:
                for j, s in enumerate(socks):
                    if j != i:
                        s.close()
                if args.metricsPort:
                    args.metricsPort += i  # one /metrics per process
                rc = _run_s3_single(
                    args,
                    reuse_port=True,
                    inval_bus=InvalBus(socks[i], ports),
                    banner=f"worker {i + 1}/{args.workers}",
                )
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(rc or 0)
        pids.append(pid)
    for s in socks:
        s.close()

    forwarded: list[int] = []

    def _forward(sig, _frame):
        forwarded.append(sig)
        for p in pids:
            try:
                os.kill(p, sig)
            except OSError:
                pass

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _forward)
    rc = 0
    for p in pids:
        try:
            _, status = os.waitpid(p, 0)
            code = os.waitstatus_to_exitcode(status) or 0
            if code < 0:
                # signal-killed: a signal we ourselves forwarded is a
                # clean shutdown (exit 0, not 256+code); anything else
                # maps to the conventional 128+N
                code = 0 if -code in forwarded else 128 - code
            rc = rc or code
        except (OSError, InterruptedError):
            pass
    return rc


def _run_s3_single(args, *, reuse_port: bool = False, inval_bus=None,
                   banner: str = "") -> int:
    from seaweedfs_tpu_torch.s3 import S3ApiServer
    from seaweedfs_tpu_torch.s3.auth import Identity

    identities = None
    if args.accessKey:
        identities = {args.accessKey: Identity(args.accessKey, args.secretKey, "admin")}
    kms = None
    if args.kms:
        from seaweedfs_tpu_torch.security.kms import make_kms

        kms = make_kms(args.kms)
    elif args.kmsKeyFile:
        from seaweedfs_tpu_torch.security.kms import LocalKms

        kms = LocalKms(args.kmsKeyFile)
    cb_config = qos_config = None
    if args.circuitBreakerFile:
        import json

        with open(args.circuitBreakerFile) as f:
            cb_config = json.load(f)
    if args.qosFile:
        import json

        with open(args.qosFile) as f:
            qos_config = json.load(f)
    shared_filer = None
    if args.filer:
        # a comma list is the sharded metadata plane: the router
        # consistent-hashes the namespace over the shards
        from seaweedfs_tpu_torch.filer.shard_ring import filer_client
        from seaweedfs_tpu_torch.wdclient import MasterClient

        shared_filer = filer_client(args.filer, MasterClient(args.master))
    gw = S3ApiServer(
        args.master,
        ip=args.ip,
        port=args.port,
        filer=shared_filer,
        identities=identities,
        kms=kms,
        lifecycle_sweep_interval=args.lifecycleSweepSec,
        circuit_breaker_config=cb_config,
        qos_config=qos_config,
        access_log=args.accessLog,
        reuse_port=reuse_port or args.reusePort,
        inval_bus=inval_bus,
        chunk_cache_mb=(args.cacheMB if args.cacheMB >= 0 else None),
        tls_cert=args.tlsCert,
        tls_key=args.tlsKey,
    )
    gw.start()
    try:
        if args.metricsPort:
            from seaweedfs_tpu_torch import stats

            stats.start_metrics_server(args.metricsPort, args.ip)
        mode = "sigv4" if identities else "open"
        tag = f" [{banner}]" if banner else ""
        # one write of the whole line: the workers of a group share stdout
        sys.stdout.write(f"s3 gateway on {gw.url} (auth={mode}){tag}\n")
        sys.stdout.flush()
        _wait_forever()
    finally:
        gw.stop()
    return 0


def _s3_flags(p) -> None:
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-accessKey", default="", help="enable SigV4 with this key")
    p.add_argument("-secretKey", default="")
    p.add_argument("-metricsPort", type=int, default=0, help="Prometheus /metrics")
    p.add_argument("-accessLog", default="",
                   help="per-request S3 access log: '-' for stderr or a file path")
    p.add_argument("-kmsKeyFile", default="",
                   help="enable SSE-S3 with this local KMS key file")
    p.add_argument("-kms", default="",
                   help="KMS provider spec: local:file.json, openbao://h:8200/"
                   "transit?token=..., aws://region, gcp://, azure://vault-url")
    p.add_argument("-circuitBreakerFile", default="",
                   help="static request-limit JSON (else polled from the filer's "
                   "/etc/s3/circuit_breaker.json via s3.circuitbreaker)")
    p.add_argument("-filer", default="",
                   help="ride a shared filer server (host:grpc_port) instead of an "
                   "embedded in-process filer; a comma list shards the namespace "
                   "over several filers (filer/shard_ring.py)")
    p.add_argument("-qosFile", default="",
                   help="static tenant/bucket QoS JSON (else polled from the "
                   "filer's /etc/s3/qos.json via the s3.qos shell command)")
    _tls_flags(p)
    p.add_argument("-lifecycleSweepSec", type=float, default=3600.0,
                   help="seconds between lifecycle expiration sweeps (0 disables)")
    p.add_argument("-workers", type=int, default=1,
                   help="gateway processes sharing -port via SO_REUSEPORT, their "
                   "caches kept coherent by filer/inval_bus.py (needs -filer)")
    p.add_argument("-reusePort", action="store_true",
                   help="bind the listen port with SO_REUSEPORT")
    p.add_argument("-cacheMB", type=float, default=-1,
                   help="hot-chunk cache (util/chunk_cache): S3-FIFO over mmap'd "
                   "segment files; default -1 reads WEED_CHUNK_CACHE_MB (0/unset = off)")


run_s3.configure = _s3_flags


@command("server", "run master + volume (+ filer, s3, webdav) in one process")
def run_server(args) -> int:
    """All-in-one node (reference `weed server -filer -s3 -webdav`)."""
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    ms = MasterServer(ip=args.ip, port=args.masterPort,
                      volume_size_limit_mb=args.volumeSizeLimitMB)
    ms.start()
    services = [ms]
    try:
        vs = VolumeServer(args.dir.split(","), ms.grpc_address, ip=args.ip, port=args.port,
                          device=args.device, data_center=args.dataCenter, rack=args.rack,
                          offset_width=args.offsetWidth)
        vs.start()
        services.append(vs)
        parts = [f"master {ms.advertise} (gRPC {ms.grpc_address})",
                 f"volume {vs.url} (gRPC {vs.ip}:{vs.grpc_port}, device {vs.device})"]
        if args.filer or args.s3 or args.webdav:
            from seaweedfs_tpu_torch.server.filer_server import FilerServer

            fs = FilerServer(ms.grpc_address, ip=args.ip, port=args.filerPort,
                             store_path=args.db or None, tls_cert=args.tlsCert,
                             tls_key=args.tlsKey)
            fs.start()
            services.append(fs)
            parts.append(f"filer {fs.url} (gRPC {fs.grpc_address})")
        if args.s3:
            from seaweedfs_tpu_torch.s3 import S3ApiServer
            from seaweedfs_tpu_torch.s3.auth import Identity

            identities = None
            if args.s3AccessKey:
                identities = {args.s3AccessKey: Identity(args.s3AccessKey, args.s3SecretKey,
                                                         "admin")}
            # ride the filer's metadata engine: shell s3.* and the S3 API
            # see one namespace (the reference's weed server -s3 shape)
            gw = S3ApiServer(ms.grpc_address, ip=args.ip, port=args.s3Port, filer=fs.filer,
                             identities=identities, tls_cert=args.tlsCert,
                             tls_key=args.tlsKey)
            gw.start()
            services.append(gw)
            parts.append(f"s3 {gw.url} ({'sigv4' if identities else 'open'})")
        if args.webdav:
            from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

            dav = WebDavServer(fs.grpc_address, ms.grpc_address, ip=args.ip,
                               port=args.webdavPort)
            dav.start()
            services.append(dav)
            parts.append(f"webdav {dav.url}")
        print("server: " + ", ".join(parts), flush=True)
        _wait_forever()
    finally:
        for svc in reversed(services):
            svc.stop()
    return 0


def _server_flags(p) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-masterPort", type=int, default=9333)
    p.add_argument("-port", type=int, default=8080, help="volume server port")
    p.add_argument("-dir", default="./data")
    p.add_argument("-offsetWidth", type=int, default=4, choices=[4, 5],
                   help="index offset bytes for NEW volumes (5 = 8TB volumes)")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-dataCenter", default="DefaultDataCenter")
    p.add_argument("-rack", default="DefaultRack")
    p.add_argument("-device", default="cuda",
                   help="the volume server's codec device: cuda (default; raises "
                   "without a GPU) or cpu")
    p.add_argument("-filer", action="store_true", help="also run a filer")
    p.add_argument("-filerPort", type=int, default=8888)
    p.add_argument("-db", default="", help="filer store (see `filer -h`)")
    p.add_argument("-s3", action="store_true", help="also run the S3 gateway")
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-s3AccessKey", default="",
                   help="require SigV4 with this key (default: OPEN, unauthenticated)")
    p.add_argument("-s3SecretKey", default="")
    p.add_argument("-webdav", action="store_true", help="also run WebDAV")
    p.add_argument("-webdavPort", type=int, default=7333)
    _tls_flags(p)


run_server.configure = _server_flags
