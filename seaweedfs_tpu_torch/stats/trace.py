"""Distributed request tracing: W3C-traceparent propagation + span ring.

The port's copy of seaweedfs_tpu/stats/trace.py: end-to-end visibility
for one request crossing client -> S3 gateway -> filer -> volume server.
Context rides the standard ``traceparent`` header
(https://www.w3.org/TR/trace-context/,
``00-<32hex trace id>-<16hex span id>-<2hex flags>``) over HTTP, and the
same key as gRPC metadata (injected and extracted by rpc.Stub and
rpc.add_service).

Finished spans land in a bounded per-process ring buffer exposed at
``/debug/tracez`` (util/debugz.py) and by the ``trace.dump`` shell
command.  In-process clusters (tests, ``cli server``) share one buffer;
multi-process clusters read each process's own /debug/tracez.

Requests the native data plane serves in C++ (a needle GET, POST or DELETE
that carried a ``traceparent``) leave packed span records in the plane;
native/dataplane.py drains them (``sw_dp_trace_drain``) on its event
cadence and replays each through :func:`record_foreign_span` as a
``native_dp`` span (``get``, ``post``, ``delete``) under the caller's span,
so they show in /debug/tracez beside the Python handlers' spans.

Always on by design: a span is one dataclass and a deque append, and the
ring bounds memory.  SEAWEEDFS_TPU_TRACE=0 disables recording (context
propagation still works, so downstream processes can keep tracing).
"""

from __future__ import annotations

import contextlib
import os
import random
import re
import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.util import wlog

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

TRACEPARENT = "traceparent"


def enabled() -> bool:
    return os.environ.get("SEAWEEDFS_TPU_TRACE", "1") != "0"


@dataclass(frozen=True)
class SpanContext:
    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars
    sampled: bool = True

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


def parse_traceparent(value: str | None) -> SpanContext | None:
    """Parse a traceparent header value; None when absent/malformed or
    when the ids are the spec's forbidden all-zero values."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if not m:
        return None
    trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


def new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str  # "" for a root span
    name: str
    service: str
    start: float  # epoch seconds
    duration_s: float = 0.0
    status: str = "ok"
    attrs: dict = field(default_factory=dict)

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)


class TraceBuffer:
    """Bounded ring of finished spans, newest kept."""

    def __init__(self, capacity: int = 4096):
        from collections import deque

        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=capacity)

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def spans(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def traces(self, trace_id: str | None = None) -> dict[str, list[Span]]:
        """Spans grouped by trace id, each group in start order."""
        groups: dict[str, list[Span]] = {}
        for s in self.spans(trace_id):
            groups.setdefault(s.trace_id, []).append(s)
        for spans in groups.values():
            spans.sort(key=lambda s: s.start)
        return groups

    def to_dicts(self, trace_id: str | None = None) -> list[dict]:
        return [
            {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                "name": s.name,
                "service": s.service,
                "start": s.start,
                "duration_ms": round(s.duration_s * 1e3, 3),
                "status": s.status,
                "attrs": s.attrs,
            }
            for s in self.spans(trace_id)
        ]

    def render_text(self, trace_id: str | None = None, limit: int = 50) -> str:
        """Human tracez: newest traces first, spans indented by parent
        depth (orphan parents — e.g. the client's own span id — show
        their children at the root)."""
        groups = self.traces(trace_id)
        # newest trace first, by the trace's earliest span start
        ordered = sorted(
            groups.items(), key=lambda kv: kv[1][0].start, reverse=True
        )[:limit]
        out = []
        for tid, spans in ordered:
            by_id = {s.span_id: s for s in spans}
            depth: dict[str, int] = {}

            def _depth(s: Span) -> int:
                d = depth.get(s.span_id)
                if d is not None:
                    return d
                parent = by_id.get(s.parent_id)
                d = 0 if parent is None or parent is s else _depth(parent) + 1
                depth[s.span_id] = d
                return d

            t0 = spans[0].start
            out.append(f"trace {tid}  ({len(spans)} spans)")
            for s in spans:
                pad = "  " * (_depth(s) + 1)
                flag = "" if s.status == "ok" else f"  [{s.status}]"
                attrs = (
                    "  " + " ".join(f"{k}={v}" for k, v in s.attrs.items())
                    if s.attrs
                    else ""
                )
                out.append(
                    f"{pad}+{(s.start - t0) * 1e3:8.2f}ms "
                    f"{s.duration_s * 1e3:9.3f}ms  {s.service}:{s.name}"
                    f"  span={s.span_id} parent={s.parent_id or '-'}"
                    f"{flag}{attrs}"
                )
            out.append("")
        return "\n".join(out) or "(no traces recorded)\n"


default_buffer = TraceBuffer()

_tls = threading.local()


def current() -> SpanContext | None:
    """The active span context on this thread (None outside any span)."""
    return getattr(_tls, "ctx", None)


def set_current(ctx: SpanContext | None) -> SpanContext | None:
    """Install ``ctx`` as this thread's active context; returns the
    previous one (callers restore it — prefer :func:`span`)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def extract_headers(headers) -> SpanContext | None:
    """Parent context from an HTTP header mapping (email.Message or dict)."""
    try:
        value = headers.get(TRACEPARENT) or headers.get("Traceparent")
    except AttributeError:
        return None
    return parse_traceparent(value)


def inject_headers(headers: dict | None = None, ctx: SpanContext | None = None) -> dict:
    """Add the active (or given) context's traceparent to ``headers``."""
    headers = headers if headers is not None else {}
    ctx = ctx or current()
    if ctx is not None:
        headers[TRACEPARENT] = ctx.to_traceparent()
    return headers


def grpc_metadata(ctx: SpanContext | None = None) -> list[tuple[str, str]]:
    """Outbound gRPC metadata carrying the active (or given) context."""
    ctx = ctx or current()
    if ctx is None:
        return []
    return [(TRACEPARENT, ctx.to_traceparent())]


def extract_grpc(context) -> SpanContext | None:
    """Parent context from a gRPC ServicerContext's invocation metadata."""
    try:
        for key, value in context.invocation_metadata() or ():
            if key == TRACEPARENT:
                return parse_traceparent(value)
    except Exception as e:  # noqa: BLE001 — tracing must never fail a call
        if wlog.V(2):
            wlog.info("trace: traceparent metadata unreadable: %s", e)
    return None


@contextlib.contextmanager
def span(
    name: str,
    service: str = "",
    *,
    parent: SpanContext | None = None,
    headers=None,
    attrs: dict | None = None,
    buffer: TraceBuffer | None = None,
):
    """Open a span: parent comes from ``parent``, else the request
    ``headers``' traceparent, else this thread's active context; roots
    mint a fresh trace id.  The span is the thread's active context for
    the duration and is recorded on exit (status=error on exception)."""
    if parent is None and headers is not None:
        parent = extract_headers(headers)
    if parent is None:
        parent = current()
    ctx = SpanContext(
        parent.trace_id if parent is not None else new_trace_id(),
        new_span_id(),
    )
    sp = Span(
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_id=parent.span_id if parent is not None else "",
        name=name,
        service=service,
        start=time.time(),
        attrs=dict(attrs or {}),
    )
    t0 = time.perf_counter()
    prev = set_current(ctx)
    try:
        yield sp
    except BaseException:
        sp.status = "error"
        raise
    finally:
        sp.duration_s = time.perf_counter() - t0
        set_current(prev)
        if enabled():
            (buffer or default_buffer).record(sp)


def stream_span(
    iterable_fn,
    name: str,
    service: str = "",
    *,
    parent: SpanContext | None = None,
    buffer: TraceBuffer | None = None,
):
    """Span over the full consumption of a lazily-produced iterable
    (server-streaming gRPC impls).  Unlike :func:`span`, the trace
    context is installed only while the wrapped iterator is actually
    executing: a long-lived stream suspended at a yield must not leak
    its context to unrelated work interleaved on the same thread."""
    if parent is None:
        parent = current()
    ctx = SpanContext(
        parent.trace_id if parent is not None else new_trace_id(),
        new_span_id(),
    )
    sp = Span(
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_id=parent.span_id if parent is not None else "",
        name=name,
        service=service,
        start=time.time(),
    )
    t0 = time.perf_counter()
    prev = set_current(ctx)
    try:
        it = iter(iterable_fn())
    finally:
        set_current(prev)
    try:
        while True:
            prev = set_current(ctx)
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                set_current(prev)
            yield item
    except BaseException:
        sp.status = "error"
        raise
    finally:
        sp.duration_s = time.perf_counter() - t0
        if enabled():
            (buffer or default_buffer).record(sp)


def record_foreign_span(
    trace_id: str,
    parent_id: str,
    name: str,
    service: str,
    start: float,
    duration_s: float,
    status: str = "ok",
    attrs: dict | None = None,
    buffer: TraceBuffer | None = None,
) -> Span:
    """Record a span whose lifetime happened elsewhere (a breaker flip, a
    retry): ids and times come from the caller, a fresh span id is minted
    here."""
    sp = Span(
        trace_id=trace_id,
        span_id=new_span_id(),
        parent_id=parent_id,
        name=name,
        service=service,
        start=start,
        duration_s=duration_s,
        status=status,
        attrs=dict(attrs or {}),
    )
    if enabled():
        (buffer or default_buffer).record(sp)
    return sp
