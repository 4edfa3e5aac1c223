"""Metrics: the port's counterpart of seaweedfs_tpu/stats.

The families the port emits, with the JAX package's names and help
strings: the repair budget's (ops/repair_budget), the plane billing's
(stats/plane), the EC service's (``EC_OPS``, ``EC_DEGRADED_READS``), the
HTTP data plane's (``VOLUME_REQUESTS``, ``VOLUME_REQUEST_SECONDS``,
``MASTER_REQUESTS``), the filer's (``FILER_REQUESTS``,
``FILER_REQUEST_SECONDS``), the raft master's (``RAFT_STATE``), the
maintenance task queue's (``ADMIN_TASKS``), the native data plane's
(``NATIVE_DP_REQUESTS``, a ``SnapshotFamily`` polled from the C++ loop), the
scrubber's and vacuum's (``DISK_CORRUPTION``, ``SCRUB_*``), the flight
recorder's (``EVENTS_DROPPED``), the S3 gateway's (``S3_*``), its tenant
QoS's (``QOS_*``) and caches' (``ENTRY_CACHE``, ``CHUNK_CACHE*``,
``META_SUB``), the RPC layer's (``RPC_*``: retries, breaker transitions
and states, channel evictions), the fault injector's
(``FAULTS_INJECTED``), the op-latency sketches (stats/sketch.py) and, in
ops/sched_cache, the schedule cache's; and one of its own,
``CUDA_KERNEL_LAUNCHES``, which a server samples from the kernels' launch
counters so a client can see them.  ``series()`` is how callers read a
family; ``render_text()`` renders every family in the Prometheus text
format of the JAX package's ``Registry.render_text``, and
``start_metrics_server`` serves it at ``/metrics`` with the ``/debug/``
pages of util/debugz.py beside it.
"""

from __future__ import annotations

import threading
from bisect import bisect_right


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
    """A family of label series, each set to a value or sampled from a
    callable at render time."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        self._fns: dict[tuple, object] = {}
        _register(self)

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def set_function(self, fn, **labels) -> None:
        with self._lock:
            self._fns[tuple(sorted(labels.items()))] = fn

    def remove(self, **labels) -> None:
        """Drop one label series (a stopped master's samplers)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._fns.pop(key, None)
            self._values.pop(key, None)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            merged = dict(self._values)
            fns = list(self._fns.items())
        merged.update((key, float(fn())) for key, fn in fns)
        if not merged:
            lines.append(f"{self.name} 0")
        for key, v in sorted(merged.items()):
            lines.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        return "\n".join(lines)


DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)


class Histogram:
    """A family of latency histograms, rendered with cumulative buckets."""

    def __init__(self, name: str, help_text: str = "", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        _register(self)

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            counts[bisect_right(self.buckets, value)] += 1  # per bucket; cumulative at render
            self._sums[key] = self._sums.get(key, 0.0) + value

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cumulative = 0
                for i, bound in enumerate(self.buckets):
                    cumulative += counts[i]
                    lines.append(f"{self.name}_bucket{_fmt_labels(key + (('le', f'{bound:g}'),))} "
                                 f"{cumulative}")
                cumulative += counts[-1]
                lines.append(f"{self.name}_bucket{_fmt_labels(key + (('le', '+Inf'),))} {cumulative}")
                lines.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums[key]:g}")
                lines.append(f"{self.name}_count{_fmt_labels(key)} {cumulative}")
        return "\n".join(lines)


class SnapshotFamily:
    """Counter and histogram families rendered from a polled snapshot: the
    seam that shows the native C++ data plane's per-verb telemetry
    (native/dataplane.py ``metrics_snapshot``) in the same /metrics output
    as the Python families.  ``set_provider`` installs a zero-arg callable
    returning ``{label: {"count", "sum_seconds", "buckets"}}``, buckets
    being cumulative ``(le_seconds, count)`` pairs; the last caller wins,
    and a provider weakrefs its owner so a stopped server renders
    nothing."""

    def __init__(self, name: str, help_text: str = "", label: str = "verb"):
        self.name = name
        self.help = help_text
        self.label = label
        self._lock = threading.Lock()
        self._provider = None
        _register(self)

    def set_provider(self, fn) -> None:
        with self._lock:
            self._provider = fn

    def snapshot(self) -> dict:
        with self._lock:
            provider = self._provider
        if provider is None:
            return {}
        try:
            return provider() or {}
        except Exception:  # noqa: BLE001 — sampling must not break a scrape
            return {}

    def render(self) -> str:
        snap = self.snapshot()
        lines = [f"# HELP {self.name}_total {self.help}", f"# TYPE {self.name}_total counter"]
        if not snap:
            lines.append(f"{self.name}_total 0")
        for key, row in sorted(snap.items()):
            # counts print as exact ints: %g's 6 significant digits would
            # put +Inf below a finite bucket past ~1e6 requests
            lines.append(f"{self.name}_total{_fmt_labels(((self.label, key),))} "
                         f"{int(row['count'])}")
        lines += [f"# HELP {self.name}_seconds {self.help} latency",
                  f"# TYPE {self.name}_seconds histogram"]
        for key, row in sorted(snap.items()):
            labels = ((self.label, key),)
            for le, cum in row.get("buckets", ()):
                lines.append(f"{self.name}_seconds_bucket{_fmt_labels(labels + (('le', le),))} "
                             f"{cum}")
            lines.append(f"{self.name}_seconds_bucket{_fmt_labels(labels + (('le', '+Inf'),))} "
                         f"{int(row['count'])}")
            lines.append(f"{self.name}_seconds_sum{_fmt_labels(labels)} {row['sum_seconds']:g}")
            lines.append(f"{self.name}_seconds_count{_fmt_labels(labels)} {int(row['count'])}")
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
            from seaweedfs_tpu_torch.util import debugz

            if self.path == "/metrics":
                code, body = 200, render_text().encode()
            elif self.path.startswith("/debug/"):
                code, body = debugz.handle(self.path)
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


VOLUME_REQUESTS = Counter(
    "weedtpu_volume_server_request_total",
    "Volume server HTTP requests by type",
)
VOLUME_REQUEST_SECONDS = Histogram(
    "weedtpu_volume_server_request_seconds",
    "Volume server HTTP request latency by type",
)
FILER_REQUESTS = Counter(
    "weedtpu_filer_request_total",
    "Filer HTTP requests by type",
)
FILER_REQUEST_SECONDS = Histogram(
    "weedtpu_filer_request_seconds",
    "Filer HTTP request latency by type",
)
MASTER_REQUESTS = Counter(
    "weedtpu_master_request_total",
    "Master RPC/HTTP requests by type",
)
EC_OPS = Counter(
    "weedtpu_ec_operations_total",
    "EC codec operations (encode/rebuild/reconstruct) by op",
)
EC_DEGRADED_READS = Counter(
    "weedtpu_ec_degraded_reads_total",
    "EC shard reads served degraded, by mode (failover/hedge/reconstruct)",
)
DISK_CORRUPTION = Counter(
    "weedtpu_disk_corruption_total",
    "Corrupt needle records detected, by path (read/scan/vacuum/scrub)",
)
SCRUB_NEEDLES = Counter(
    "weedtpu_scrub_needles_total",
    "Needles CRC-verified by the scrubber, by result (ok/corrupt)",
)
SCRUB_BYTES = Counter(
    "weedtpu_scrub_bytes_total",
    "Bytes read and verified by the scrubber",
)
SCRUB_REPAIRS = Counter(
    "weedtpu_scrub_repairs_total",
    "Scrubber repairs by source (replica/ec_reconstruct) and outcome",
)
SCRUB_PASSES = Counter(
    "weedtpu_scrub_passes_total",
    "Completed scrub passes over a volume, by kind (volume/ec)",
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
FILER_SHARD_REQUESTS = Counter(
    "weedtpu_filer_shard_requests_total",
    "Shard-router filer RPCs by op and shard address",
)
FILER_SHARD_FANOUT = Counter(
    "weedtpu_filer_shard_fanout_total",
    "Cross-shard fan-outs (merged listings, two-phase moves, tree deletes) "
    "by op",
)
FILER_SHARD_UNAVAILABLE = Counter(
    "weedtpu_filer_shard_unavailable_total",
    "Filer shard calls shed as unavailable (breaker open / UNAVAILABLE / "
    "deadline), by shard address",
)
INVAL_BUS_DATAGRAMS = Counter(
    "weedtpu_s3_inval_bus_datagrams_total",
    "Worker-group invalidation-bus datagrams by direction: sent (one per "
    "peer) and received",
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
ADMIN_TASKS = Counter(
    "weedtpu_admin_tasks_total",
    "Maintenance tasks by kind and outcome",
)
NATIVE_DP_REQUESTS = SnapshotFamily(
    "weedtpu_volume_server_native_request",
    "Native data-plane requests by verb",
)
RAFT_STATE = Gauge(
    "weedtpu_master_raft",
    "Raft consensus state: term and role (leader=1/follower=0) per field",
)
EVENTS_DROPPED = Counter(
    "weedtpu_events_dropped_total",
    "Flight-recorder events displaced from the bounded ring before being "
    "read (stats/events.py)",
)
CUDA_KERNEL_LAUNCHES = Gauge(
    "weedtpu_cuda_kernel_launches",
    "CUDA kernel launches of this process by kernel, read from the launch "
    "counters of ops/rs_cuda (gf_apply = K1, gf_planes_apply = K2, gf_pack = "
    "K3, gf_unpack = K4)",
)
S3_REQUESTS = Counter(
    "weedtpu_s3_request_total",
    "S3 gateway requests by action and code",
)
S3_REQUEST_SECONDS = Histogram(
    "weedtpu_s3_request_seconds",
    "S3 gateway request latency by action",
)
S3_THROTTLED = Counter(
    "weedtpu_s3_throttled_total",
    "Requests shed by the S3 circuit breaker, by scope and limit key",
)
QOS_REQUESTS = Counter(
    "weedtpu_qos_requests_total",
    "Tenant/bucket QoS admission decisions by scope and outcome "
    "(admitted / shed_ops / shed_bytes / shed_quota)",
)
QOS_WAIT_SECONDS = Counter(
    "weedtpu_qos_retry_after_seconds_total",
    "Seconds of Retry-After handed to shed requests (load pushed back "
    "to clients), by scope",
)
ENTRY_CACHE = Counter(
    "weedtpu_entry_cache_total",
    "Gateway entry-cache events (hit / neg_hit / miss / neg_miss / "
    "invalidate)",
)
META_SUB = Counter(
    "weedtpu_filer_meta_sub_total",
    "Cross-process metadata-subscription invalidation plane events "
    "(event / reconnect / gap), by kind",
)
CHUNK_CACHE = Counter(
    "weedtpu_chunk_cache_total",
    "Gateway hot-chunk cache events (hit / miss / admit / reject / "
    "evict / invalidate)",
)
CHUNK_CACHE_BYTES = Gauge(
    "weedtpu_chunk_cache_bytes",
    "Bytes held by the gateway hot-chunk cache, by tier (ram / segment)",
)
RPC_CLIENT_RETRIES = Counter(
    "weedtpu_rpc_client_retries_total",
    "Client RPC retries by service, method and status code",
)
RPC_BREAKER_TRANSITIONS = Counter(
    "weedtpu_rpc_breaker_transitions_total",
    "Circuit breaker state transitions by peer and new state",
)
RPC_BREAKER_STATE = Gauge(
    "weedtpu_rpc_breaker_state",
    "Circuit breaker state per peer (0 closed, 1 half-open, 2 open)",
)
RPC_CHANNEL_EVICTIONS = Counter(
    "weedtpu_rpc_channel_evictions_total",
    "Dead cached gRPC channels evicted, by peer",
)
FAULTS_INJECTED = Counter(
    "weedtpu_faults_injected_total",
    "Faults injected by the WEED_FAULTS harness, by site/service/kind",
)
