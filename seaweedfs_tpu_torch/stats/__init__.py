"""Metrics: the port's counterpart of seaweedfs_tpu/stats.

Only the counter families the port emits so far, with the JAX package's
names and help strings: the repair budget's (ops/repair_budget), the
plane billing's (stats/plane), the EC service's (``EC_OPS``,
``EC_DEGRADED_READS``) and, in ops/sched_cache, the schedule cache's; and
one of its own, ``CUDA_KERNEL_LAUNCHES``, which a server samples from the
kernels' launch counters so a client can see them.
``series()`` is how callers read a family; ``render_text()`` renders every
family in the Prometheus text format of the JAX package's
``Registry.render_text``, and ``start_metrics_server`` serves it at
``/metrics`` (the ``/debug/`` pages are not ported).
"""

from __future__ import annotations

import threading


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


# Every family, in registration order: what ``render_text`` renders.
_FAMILIES: list = []
_FAMILIES_LOCK = threading.Lock()


def _register(family) -> None:
    with _FAMILIES_LOCK:
        _FAMILIES.append(family)


class Counter:
    """A monotonically increasing family of label series."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        _register(self)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def series(self) -> dict[tuple, float]:
        """Every label series (a sorted tuple of (label, value) pairs) with
        its value."""
        with self._lock:
            return dict(self._values)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values:
                lines.append(f"{self.name} 0")
            for key, v in sorted(self._values.items()):
                lines.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        return "\n".join(lines)


class Gauge:
    """A family of label series sampled from callables at render time (the
    ``set_function`` part of the JAX package's Gauge)."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._fns: dict[tuple, object] = {}
        _register(self)

    def set_function(self, fn, **labels) -> None:
        with self._lock:
            self._fns[tuple(sorted(labels.items()))] = fn

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            fns = sorted(self._fns.items())
        if not fns:
            lines.append(f"{self.name} 0")
        for key, fn in fns:
            lines.append(f"{self.name}{_fmt_labels(key)} {float(fn()):g}")
        return "\n".join(lines)


def render_text() -> str:
    with _FAMILIES_LOCK:
        families = list(_FAMILIES)
    return "\n".join(f.render() for f in families) + "\n"


def start_metrics_server(port: int, ip: str = "127.0.0.1"):
    """Standalone ``/metrics`` listener (the reference's -metricsPort).
    Returns the server (it has .server_address and .shutdown())."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path == "/metrics":
                code, body = 200, render_text().encode()
            else:
                code, body = 404, b"not found\n"
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((ip, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


EC_OPS = Counter(
    "weedtpu_ec_operations_total",
    "EC codec operations (encode/rebuild/reconstruct) by op",
)
EC_DEGRADED_READS = Counter(
    "weedtpu_ec_degraded_reads_total",
    "EC shard reads served degraded, by mode (failover/hedge/reconstruct)",
)
REPAIR_BYTES = Counter(
    "weedtpu_repair_bytes_total",
    "EC repair traffic by storage class (code: rs/lrc/volume), repair mode "
    "(local/global/replica/move) and direction (dir: read/moved)",
)
REPAIR_OPS = Counter(
    "weedtpu_repair_ops_total",
    "EC repair operations by storage class (code) and repair mode",
)
REPAIR_WAIT_SECONDS = Counter(
    "weedtpu_repair_wait_seconds_total",
    "Seconds repair work waited on the WEED_REPAIR_RATE_MB bandwidth budget",
)
PLANE_BYTES = Counter(
    "weedtpu_plane_bytes_total",
    "Bytes crossing the storage-backend and http-pool seams, attributed "
    "to the plane that caused them (serve / scrub / vacuum / ec_repair / "
    "replication / cache_fill), by direction (dir: read / write)",
)
PLANE_OP_SECONDS = Counter(
    "weedtpu_plane_op_seconds_total",
    "Seconds spent inside storage-backend and http-pool operations, by "
    "plane",
)
CUDA_KERNEL_LAUNCHES = Gauge(
    "weedtpu_cuda_kernel_launches",
    "CUDA kernel launches of this process by kernel, read from the launch "
    "counters of ops/rs_cuda (gf_apply = K1, gf_planes_apply = K2, gf_pack = "
    "K3, gf_unpack = K4)",
)
