"""``volume``: run the port's volume server (the EC gRPC service).

The port of seaweedfs_tpu/commands/servers.py's ``volume`` command, with
``-dir``, ``-ip``, ``-port``, ``-grpcPort`` (default ``-port`` + 10000, as
there; with ``-port 0``, a free port), ``-metricsPort`` (a ``/metrics``
listener; 0 picks a free port, none when left out) and ``-device``
(default ``cuda``; ``cpu`` runs the codec on the host).  The port has no
HTTP needle data path, so ``-port`` binds nothing itself.  The first line
on stdout names the ports bound.  The server
resolves its device at start: without CUDA, and without ``-device cpu``,
it raises and exits.  SIGINT or SIGTERM stops it.
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


@command("volume", "run a volume server (the EC shard gRPC service)")
def run_volume(args) -> int:
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    vs = VolumeServer(
        args.dir.split(","),
        ip=args.ip,
        port=args.port,
        grpc_port=args.grpcPort,
        metrics_port=args.metricsPort,
        device=args.device,
    )
    vs.start()
    metrics = f", metrics on {vs.ip}:{vs.metrics_port}" if vs.metrics_port is not None else ""
    print(f"volume server gRPC on {vs.ip}:{vs.grpc_port} (device {vs.device}){metrics}", flush=True)
    try:
        _wait_forever()
    finally:
        vs.stop()
    return 0


def _volume_flags(p) -> None:
    p.add_argument("-dir", default="./data", help="comma-separated data dirs")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-grpcPort", type=int, default=0, help="default port+10000")
    p.add_argument("-metricsPort", type=int, default=None,
                   help="/metrics listener port (0: a free one; none when left out)")
    p.add_argument("-device", default="cuda",
                   help="codec device: cuda (default; raises without a GPU) or cpu")


run_volume.configure = _volume_flags
