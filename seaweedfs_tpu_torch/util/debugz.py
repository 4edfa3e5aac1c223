"""Debug/profiling endpoints served from the metrics listener.

The port's copy of seaweedfs_tpu/util/debugz.py, counterpart of the
reference's pprof surface (weed/util/grace/pprof.go,
-pprof flag exposing /debug/pprof/): every server's -metricsPort also
answers

  /debug/threadz            every thread's current stack
  /debug/pprof/profile      sampling profile over ?seconds=N (default 5)
  /debug/vars               process facts as JSON
  /debug/tracez             recent request traces (stats/trace.py ring);
                            ?trace_id=... filters, ?json=1 for machines
  /debug/breakers           per-peer RPC circuit breaker states (JSON)
  /debug/faults             the active WEED_FAULTS plan + fire counts
  /debug/scrub              scrubber state: rate, passes, per-volume results
  /debug/vacuum             auto-vacuum state: passes, reclaimed bytes
  /debug/repair             repair bandwidth budget + weedtpu_repair_* totals
  /debug/qos                tenant/bucket QoS limits + shed counts
  /debug/cachez             hot-chunk cache tiers: S3-FIFO queue sizes,
                            hit rate, segment files, eviction counts
  /debug/sketchz            per-op-class latency sketches (stats/sketch.py);
                            ?binary=1 for the mergeable dump the cluster
                            aggregator consumes
  /debug/sloz               SLO evaluation (util/slo.py) against WEED_SLO
                            or ?spec=...; ?json=1 for machines
  /debug/eventz             the flight-recorder ring (stats/events.py);
                            ?kind=, ?limit=, ?json=1
  /debug/clusterz           merged cluster view (stats/cluster_agg.py);
                            ?members=host:port,... or WEED_CLUSTER_MEMBERS

The CPU profile is a wall-clock stack sampler over every thread
(cProfile would only see the handler's own idle thread); output is a
flat frame histogram, most-sampled first.  sys._current_frames cannot
see past a C call, so a blocking native entry point may register itself
in ``native_call`` around its ctypes call and the sampler prepends a
synthetic ``<native>:0:<symbol>`` innermost frame for that thread.  The
native data plane's px loop (native/dataplane.py, a C thread) gets a
section of its own at the end of /debug/threadz once the splice library is
loaded in the process: its engine mode and the ``sw_px_stats`` slots, with
the splice ladder's Python-side steps (``ladder_*``).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import sys
import threading
import time
import traceback
import urllib.parse

# thread ident -> native symbol currently blocking that thread (dict
# ops are GIL-atomic; entries are transient around ctypes calls)
_native_calls: dict[int, str] = {}


@contextlib.contextmanager
def native_call(symbol: str):
    """Mark the calling thread as parked inside the named C entry point
    for the duration of the block, so /debug/pprof/profile and
    /debug/threadz can attribute the time to the native symbol instead
    of the Python caller."""
    ident = threading.get_ident()
    _native_calls[ident] = symbol
    try:
        yield
    finally:
        _native_calls.pop(ident, None)


def _px_loop_section(out: io.StringIO) -> None:
    """The native px loop is a C thread: invisible to
    threading.enumerate and sys._current_frames.  When the px library
    is already loaded (never load/build it from a debug handler), show
    its engine mode and sw_px_stats slot snapshot here instead."""
    dp = sys.modules.get("seaweedfs_tpu_torch.native.dataplane")
    if dp is None or getattr(dp, "_px_lib", None) is None:
        return
    try:
        snap = dp.px_stats()
    except Exception as e:  # noqa: BLE001 — diagnostics must not 500
        out.write(f"--- native px loop: stats unavailable ({e}) ---\n\n")
        return
    loop_jobs = (
        snap.get("loop_get_jobs", 0)
        + snap.get("loop_put_jobs", 0)
        + snap.get("loop_cache_jobs", 0)
    )
    if loop_jobs:
        # only ask for the mode once the loop has demonstrably run:
        # px_loop_mode() lazy-starts the loop, which a read-only
        # debug endpoint must never do
        modes = {2: "io_uring", 1: "epoll", 0: "off"}
        mode = modes.get(dp.px_loop_mode(), "?")
    else:
        mode = "idle (not started)"
    out.write(f"--- native px loop (C thread, mode={mode}) ---\n")
    for slot, v in snap.items():
        out.write(f"  sw_px_stats.{slot} = {v}\n")
    out.write("\n")


def _threadz() -> bytes:
    out = io.StringIO()
    frames = sys._current_frames()  # noqa: SLF001 — the documented API for this
    for t in threading.enumerate():
        native = _native_calls.get(t.ident)
        suffix = f" [in native {native}]" if native else ""
        out.write(f"--- thread {t.name} (daemon={t.daemon}){suffix} ---\n")
        frame = frames.get(t.ident)
        if frame is not None:
            out.write("".join(traceback.format_stack(frame)))
        out.write("\n")
    _px_loop_section(out)
    return out.getvalue().encode()


def _profile(seconds: float, hz: float = 100.0) -> bytes:
    """Sample every thread's stack at ``hz`` for ``seconds``; emit a
    frame histogram (file:line:function, samples, %)."""
    seconds = min(seconds, 60.0)
    interval = 1.0 / hz
    counts: collections.Counter[str] = collections.Counter()
    me = threading.get_ident()
    samples = 0
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():  # noqa: SLF001
            if ident == me:
                continue
            native = _native_calls.get(ident)
            if native is not None:
                # the thread is parked inside a C call the frame walk
                # below cannot see — bill the sample to the native
                # symbol as the innermost frame
                counts[f"<native>:0:{native}"] += 1
            while frame is not None:
                code = frame.f_code
                counts[
                    f"{code.co_filename}:{frame.f_lineno}:{code.co_name}"
                ] += 1
                frame = frame.f_back
        samples += 1
        time.sleep(interval)
    out = io.StringIO()
    out.write(f"# {samples} samples over {seconds}s at {hz:g}Hz\n")
    for frame_id, n in counts.most_common(100):
        out.write(f"{n:8d}  {100.0 * n / max(1, samples):6.1f}%  {frame_id}\n")
    return out.getvalue().encode()


def _vars() -> bytes:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return json.dumps(
        {
            "pid": os.getpid(),
            "threads": threading.active_count(),
            "max_rss_kb": ru.ru_maxrss,
            "user_cpu_s": ru.ru_utime,
            "sys_cpu_s": ru.ru_stime,
            "uptime_s": time.monotonic(),
        },
        indent=2,
    ).encode()


_profile_lock = threading.Lock()


def handle(path: str) -> tuple[int, bytes]:
    url = urllib.parse.urlparse(path)
    q = urllib.parse.parse_qs(url.query)
    if url.path == "/debug/threadz":
        return 200, _threadz()
    if url.path == "/debug/pprof/profile":
        try:
            seconds = float(q.get("seconds", ["5"])[0])
        except ValueError:
            return 400, b"seconds must be a number\n"
        seconds = min(max(seconds, 0.05), 60.0)
        # one profiler at a time: each runs a 100Hz all-thread sampler
        if not _profile_lock.acquire(blocking=False):
            return 429, b"a profile is already running\n"
        try:
            return 200, _profile(seconds)
        finally:
            _profile_lock.release()
    if url.path == "/debug/vars":
        return 200, _vars()
    if url.path == "/debug/tracez":
        from seaweedfs_tpu_torch.stats import trace

        trace_id = q.get("trace_id", [""])[0] or None
        if q.get("json", [""])[0]:
            return 200, json.dumps(
                trace.default_buffer.to_dicts(trace_id), indent=2
            ).encode()
        try:
            limit = int(q.get("limit", ["50"])[0])
        except ValueError:
            limit = 50
        return 200, trace.default_buffer.render_text(trace_id, limit).encode()
    if url.path == "/debug/breakers":
        from seaweedfs_tpu_torch.util import resilience

        return 200, json.dumps(resilience.snapshot(), indent=2).encode()
    if url.path == "/debug/faults":
        from seaweedfs_tpu_torch.util import faults

        return 200, json.dumps(faults.snapshot(), indent=2).encode()
    if url.path == "/debug/qos":
        from seaweedfs_tpu_torch.util import limiter

        return 200, json.dumps(limiter.debug_snapshot(), indent=2).encode()
    if url.path == "/debug/cachez":
        from seaweedfs_tpu_torch.util import chunk_cache

        return 200, json.dumps(chunk_cache.debug_snapshot(), indent=2).encode()
    if url.path == "/debug/scrub":
        from seaweedfs_tpu_torch.storage import scrub

        return 200, json.dumps(scrub.snapshot(), indent=2).encode()
    if url.path == "/debug/vacuum":
        from seaweedfs_tpu_torch.storage import vacuum

        return 200, json.dumps(vacuum.snapshot(), indent=2).encode()
    if url.path == "/debug/repair":
        from seaweedfs_tpu_torch.ops import repair_budget

        return 200, json.dumps(repair_budget.snapshot(), indent=2).encode()
    if url.path == "/debug/sketchz":
        from seaweedfs_tpu_torch.stats import sketch

        if q.get("binary", [""])[0]:
            return 200, sketch.OP_LATENCY.dump()
        return 200, json.dumps(sketch.debug_snapshot(), indent=2).encode()
    if url.path == "/debug/sloz":
        from seaweedfs_tpu_torch.util import slo

        return slo.debug_body(q)
    if url.path == "/debug/eventz":
        from seaweedfs_tpu_torch.stats import events

        return events.debug_body(q)
    if url.path == "/debug/clusterz":
        from seaweedfs_tpu_torch.stats import cluster_agg

        return cluster_agg.debug_body(q)
    return 404, b"unknown debug endpoint\n"
