"""``cli admin`` and ``cli worker``: the maintenance daemons (reference
weed/command/admin.go / worker.go), and ``cli telemetry``, the collector
that masters started with ``-telemetryUrl`` report to (reference
telemetry/server); the port's copy of seaweedfs_tpu/commands/admin_cmd.py,
with its flags and defaults.

None takes ``-device``: they run no kernel and never touch CUDA.  The
EC encode and rebuild a worker drives run in the volume servers, which
keep their own ``-device``.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.commands import command


@command("admin", "run the maintenance admin server (scanner + task queue)")
def run_admin(args) -> int:
    from seaweedfs_tpu_torch.admin import AdminServer, MaintenancePolicy
    from seaweedfs_tpu_torch.commands.servers import _wait_forever

    policy = MaintenancePolicy(
        ec_full_percent=args.ecFullPercent,
        ec_quiet_seconds=args.ecQuietSeconds,
        vacuum_garbage_ratio=args.garbageThreshold,
        scan_interval=args.scanInterval,
        enable_ec=not args.noEc,
        enable_vacuum=not args.noVacuum,
    )
    srv = AdminServer(
        args.master,
        port=args.port,
        ip=args.ip,
        policy=policy,
        username=args.adminUser,
        password=args.adminPassword,
        config_path=args.configFile,
        filer_address=args.filer,
    )
    srv.start()
    mode = "auth" if srv.auth_enabled else "OPEN (set -adminPassword)"
    print(
        f"admin server on http://{srv.url} (master {args.master}, {mode})",
        flush=True,
    )
    try:
        _wait_forever()
    finally:
        srv.stop()
    return 0


def _admin_flags(p):
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=23646)
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-scanInterval", type=float, default=30.0, help="seconds")
    p.add_argument("-ecFullPercent", type=float, default=95.0)
    p.add_argument("-ecQuietSeconds", type=float, default=3600.0)
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument("-noEc", action="store_true", help="disable auto EC encode")
    p.add_argument("-noVacuum", action="store_true", help="disable auto vacuum")
    p.add_argument(
        "-adminUser", default="", help="UI/API username (default admin)"
    )
    p.add_argument(
        "-adminPassword", default="",
        help="enable auth with this password (or WEED_ADMIN_PASSWORD)",
    )
    p.add_argument(
        "-configFile", default="",
        help="persist policy edits from the management API here",
    )
    p.add_argument(
        "-filer", default="",
        help="filer gRPC address: enables the file browser and user "
        "management pages",
    )


run_admin.configure = _admin_flags


@command("worker", "run a maintenance worker (executes EC/vacuum tasks)")
def run_worker(args) -> int:
    from seaweedfs_tpu_torch.admin import Worker
    from seaweedfs_tpu_torch.commands.servers import _wait_forever

    w = Worker(
        args.master,
        admin_address=args.admin,
        kinds=args.kinds.split(",") if args.kinds else None,
        poll_interval=args.pollInterval,
        http_auth=(
            (args.adminUser or "admin", args.adminPassword)
            if args.adminPassword
            else None
        ),
    )
    w.start()
    print(f"worker {w.worker_id} polling admin {args.admin}", flush=True)
    try:
        _wait_forever()
    finally:
        w.stop()
    return 0


def _worker_flags(p):
    p.add_argument("-admin", default="127.0.0.1:23646", help="admin HTTP address")
    p.add_argument("-master", default="127.0.0.1:19333", help="master gRPC address")
    p.add_argument("-kinds", default="", help="comma list: ec_encode,vacuum")
    p.add_argument("-pollInterval", type=float, default=2.0)
    p.add_argument("-adminUser", default="", help="Basic auth user (default admin)")
    p.add_argument(
        "-adminPassword", default="",
        help="Basic auth password (or WEED_ADMIN_PASSWORD)",
    )


run_worker.configure = _worker_flags


@command("telemetry", "run a telemetry collector server (reference telemetry/server)")
def run_telemetry(args) -> int:
    from seaweedfs_tpu_torch.cluster.telemetry_server import TelemetryServer
    from seaweedfs_tpu_torch.commands.servers import _wait_forever

    srv = TelemetryServer(ip=args.ip, port=args.port, stale_after=args.staleAfterSec).start()
    print(
        f"telemetry collector on {srv.url} "
        f"(POST /api/collect; /api/stats /api/instances /metrics)",
        flush=True,
    )
    try:
        _wait_forever()
    finally:
        srv.stop()
    return 0


def _telemetry_flags(p):
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=23650)
    p.add_argument(
        "-staleAfterSec", type=float, default=24 * 3600.0,
        help="drop clusters not reporting for this long",
    )


run_telemetry.configure = _telemetry_flags
