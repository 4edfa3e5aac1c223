"""Mergeable latency sketches: bounded-memory tail quantiles per op class.

The port's copy of seaweedfs_tpu/stats/sketch.py.  The fixed-bucket
Histograms in stats/__init__.py cannot be merged across gateway workers,
filers and volume servers into an accurate cluster-wide p99: the bucket
grid quantizes the tail, and cross-process reduction of pre-bucketed
counts compounds the error.  This module is the DDSketch construction
(log-spaced buckets with relative accuracy ``alpha``): any value v lands
in bucket ceil(log_gamma(v)) with gamma = (1+alpha)/(1-alpha), so every
reported quantile is within a multiplicative ``alpha`` of the true rank
value, merge() is exact (bucket counts add), and memory stays bounded by
the dynamic range (~1500 buckets span nanoseconds to hours at alpha=1%).

Latency is recorded under a closed op-class vocabulary (OP_CLASSES):
free-string op classes would explode label cardinality, so ``record()``
rejects any class that is not registered.  The process singleton
``OP_LATENCY`` keeps a sliding time window per op class (ring of
sub-sketches rotated by wall-progression, merged on read) and renders
into /metrics as a Prometheus summary; /debug/sketchz serves the same
window as JSON or as the binary dump the cluster aggregator
(stats/cluster_agg.py) merges across members, byte-compatible with the
JAX package's.
"""

from __future__ import annotations

import base64
import math
import struct
import threading
import time

from seaweedfs_tpu_torch import stats

# ---- op-class vocabulary (the only legal sketch keys) --------------------

OP_S3_GET_SMALL = "s3.get.small"
OP_S3_GET_LARGE = "s3.get.large"
OP_S3_PUT = "s3.put"
OP_S3_DELETE = "s3.delete"
OP_S3_LIST = "s3.list"
OP_S3_HEAD = "s3.head"
OP_S3_OTHER = "s3.other"
OP_META_LOOKUP = "meta.lookup"
OP_META_LIST = "meta.list"
OP_META_CREATE = "meta.create"
OP_META_UPDATE = "meta.update"
OP_META_RENAME = "meta.rename"
OP_META_DELETE = "meta.delete"
OP_VOLUME_READ = "volume.read"
OP_VOLUME_WRITE = "volume.write"

OP_CLASSES = frozenset({
    OP_S3_GET_SMALL,
    OP_S3_GET_LARGE,
    OP_S3_PUT,
    OP_S3_DELETE,
    OP_S3_LIST,
    OP_S3_HEAD,
    OP_S3_OTHER,
    OP_META_LOOKUP,
    OP_META_LIST,
    OP_META_CREATE,
    OP_META_UPDATE,
    OP_META_RENAME,
    OP_META_DELETE,
    OP_VOLUME_READ,
    OP_VOLUME_WRITE,
})

# the small/large GET split matches the chunk cache's small-object tier
# (WEED_CHUNK_CACHE_SMALL_KB default): the two populations have
# different SLOs because one is a RAM/page-cache hit and the other is a
# multi-chunk streamed read
SMALL_GET_BYTES = 64 * 1024

# both vocabularies appear here: the gateway dispatch records IAM
# action names (s3:ListBucket -> "ListBucket", server/_request_action),
# while older callers pass S3 API operation names ("ListObjectsV2")
_S3_LIST_ACTIONS = frozenset({
    "ListObjectsV2", "ListObjects", "ListBuckets", "ListMultipartUploads",
    "ListParts", "ListObjectVersions",
    "ListBucket", "ListAllMyBuckets", "ListBucketVersions",
    "ListBucketMultipartUploads", "ListMultipartUploadParts",
})


def s3_op_class(action: str, resp_bytes: int) -> str:
    """Map an S3 action name (as recorded by the gateway dispatch) plus
    the response body size onto the op-class vocabulary."""
    if action == "GetObject":
        return OP_S3_GET_SMALL if resp_bytes <= SMALL_GET_BYTES else OP_S3_GET_LARGE
    if action in ("PutObject", "UploadPart", "CompleteMultipartUpload",
                  "CopyObject", "CreateMultipartUpload"):
        return OP_S3_PUT
    if action in ("DeleteObject", "DeleteObjects", "AbortMultipartUpload"):
        return OP_S3_DELETE
    if action in _S3_LIST_ACTIONS:
        return OP_S3_LIST
    if action in ("HeadObject", "HeadBucket"):
        return OP_S3_HEAD
    return OP_S3_OTHER


# ---- the sketch ----------------------------------------------------------

ALPHA_DEFAULT = 0.01


class Sketch:
    """DDSketch with a sparse (dict) bucket store.

    ``add(v)`` for v > 0 increments bucket ceil(ln(v)/ln(gamma));
    ``quantile(q)`` walks the cumulative counts and returns the bucket
    midpoint 2·gamma^i/(gamma+1), which is within relative ``alpha`` of
    the true q-quantile.  Non-positive values collapse into a dedicated
    zero bucket (durations can round to 0 at clock resolution).
    ``merge`` adds bucket counts — exact, associative, commutative.

    NOT thread-safe; callers (WindowedSketch, SketchFamily) lock.
    """

    __slots__ = (
        "alpha", "_gamma_ln", "buckets", "zero", "count", "sum", "min", "max",
    )

    def __init__(self, alpha: float = ALPHA_DEFAULT):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self._gamma_ln = math.log((1.0 + alpha) / (1.0 - alpha))
        self.buckets: dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value: float, n: int = 1) -> None:
        if n <= 0:
            return
        self.count += n
        self.sum += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= 0.0:
            self.zero += n
            return
        i = math.ceil(math.log(value) / self._gamma_ln)
        self.buckets[i] = self.buckets.get(i, 0) + n

    def _bucket_value(self, i: int) -> float:
        # midpoint of (gamma^(i-1), gamma^i]: 2·gamma^i/(gamma+1)
        gamma = math.exp(self._gamma_ln)
        return 2.0 * math.exp(i * self._gamma_ln) / (gamma + 1.0)

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) within relative error alpha;
        0.0 on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = self.zero
        if rank < seen:
            return 0.0 if self.min >= 0 else self.min
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank < seen:
                # clamp into the observed range: the edge buckets
                # otherwise overshoot min/max by up to alpha
                return min(max(self._bucket_value(i), self.min), self.max)
        return self.max

    def merge(self, other: "Sketch") -> "Sketch":
        """Fold ``other`` into self (exact: bucket counts add).  The two
        sketches must share alpha — bucket indexes are only comparable
        on the same gamma grid."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with alpha {self.alpha} and {other.alpha}"
            )
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def copy(self) -> "Sketch":
        s = Sketch(self.alpha)
        s.buckets = dict(self.buckets)
        s.zero = self.zero
        s.count = self.count
        s.sum = self.sum
        s.min = self.min
        s.max = self.max
        return s

    def to_dict(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum_s": self.sum,
            "min_ms": self.min * 1e3,
            "max_ms": self.max * 1e3,
            "p50_ms": self.quantile(0.5) * 1e3,
            "p90_ms": self.quantile(0.9) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
        }


# ---- sliding time window -------------------------------------------------


class WindowedSketch:
    """A ring of per-time-slot sub-sketches: ``add`` writes the current
    slot, ``merged`` folds the slots still inside the window, and slot
    reuse IS expiry — a slot index that wraps around overwrites the
    sketch from one window ago.  Reads therefore see the trailing
    [window - slot, window] seconds of samples with slot-granular decay.

    ``clock`` is injectable for tests; defaults to time.monotonic.
    Thread-safe.
    """

    def __init__(
        self,
        alpha: float = ALPHA_DEFAULT,
        window_s: float = 120.0,
        slots: int = 12,
        clock=time.monotonic,
    ):
        if slots < 2:
            raise ValueError("need at least 2 slots for a sliding window")
        self.alpha = alpha
        self.window_s = float(window_s)
        self.slots = slots
        self.slot_s = self.window_s / slots
        self._clock = clock
        self._lock = threading.Lock()
        # ring[i] = [slot_no, Sketch]; slot_no stamps which window
        # generation the entry belongs to so stale slots are skippable
        self._ring: list[list] = [[-1, Sketch(alpha)] for _ in range(slots)]

    def _slot_no(self, now: float) -> int:
        return int(now / self.slot_s)

    def add(self, value: float) -> None:
        sn = self._slot_no(self._clock())
        idx = sn % self.slots
        with self._lock:
            entry = self._ring[idx]
            if entry[0] != sn:
                entry[0] = sn
                entry[1] = Sketch(self.alpha)
            entry[1].add(value)

    def merged(self) -> Sketch:
        """The union of every slot still inside the window."""
        sn_now = self._slot_no(self._clock())
        out = Sketch(self.alpha)
        with self._lock:
            for slot_no, sk in self._ring:
                if slot_no > sn_now - self.slots and slot_no >= 0:
                    out.merge(sk)
        return out


# ---- binary dump (the cluster aggregator's merge wire format) ------------

_DUMP_MAGIC = b"WSKD"
_DUMP_VERSION = 1


def dump_sketches(sketches: dict[str, Sketch]) -> bytes:
    """Serialize {op_class: Sketch} for /debug/sketchz?binary=1."""
    out = [_DUMP_MAGIC, struct.pack("<HI", _DUMP_VERSION, len(sketches))]
    for op in sorted(sketches):
        sk = sketches[op]
        ob = op.encode()
        mn = sk.min if sk.count else 0.0
        mx = sk.max if sk.count else 0.0
        out.append(struct.pack("<H", len(ob)))
        out.append(ob)
        out.append(struct.pack(
            "<dQdddQI", sk.alpha, sk.count, sk.sum, mn, mx, sk.zero,
            len(sk.buckets),
        ))
        for i in sorted(sk.buckets):
            out.append(struct.pack("<iQ", i, sk.buckets[i]))
    return b"".join(out)


def parse_dump(data: bytes) -> dict[str, Sketch]:
    """Inverse of dump_sketches; raises ValueError on a malformed dump."""
    if len(data) < 10 or data[:4] != _DUMP_MAGIC:
        raise ValueError("not a sketch dump (bad magic)")
    version, n = struct.unpack_from("<HI", data, 4)
    if version != _DUMP_VERSION:
        raise ValueError(f"unsupported sketch dump version {version}")
    off = 10
    out: dict[str, Sketch] = {}
    for _ in range(n):
        (oplen,) = struct.unpack_from("<H", data, off)
        off += 2
        op = data[off:off + oplen].decode()
        off += oplen
        alpha, count, total, mn, mx, zero, nbuckets = struct.unpack_from(
            "<dQdddQI", data, off
        )
        off += struct.calcsize("<dQdddQI")
        sk = Sketch(alpha)
        sk.count = count
        sk.sum = total
        sk.zero = zero
        sk.min = mn if count else math.inf
        sk.max = mx if count else -math.inf
        for _ in range(nbuckets):
            i, c = struct.unpack_from("<iQ", data, off)
            off += struct.calcsize("<iQ")
            sk.buckets[i] = c
        out[op] = sk
    return out


def merge_dumps(dumps: list[bytes]) -> dict[str, Sketch]:
    """Parse and fold several members' dumps into one {op: Sketch}."""
    merged: dict[str, Sketch] = {}
    for d in dumps:
        for op, sk in parse_dump(d).items():
            if op in merged:
                merged[op].merge(sk)
            else:
                merged[op] = sk
    return merged


# ---- the /metrics-rendered family ----------------------------------------


class SketchFamily:
    """Per-op-class windowed sketches rendered as a Prometheus summary
    (quantile label) over the sliding window.  ``record`` rejects op
    classes outside OP_CLASSES."""

    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(
        self,
        name: str,
        help_text: str = "",
        alpha: float = ALPHA_DEFAULT,
        window_s: float = 120.0,
    ):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        stats._register(self)
        self.alpha = alpha
        self.window_s = window_s
        self._windows: dict[str, WindowedSketch] = {}

    def record(self, op: str, seconds: float) -> None:
        """Record one operation's latency under its op class."""
        if op not in OP_CLASSES:
            raise ValueError(f"unregistered op class {op!r}")
        with self._lock:
            w = self._windows.get(op)
            if w is None:
                w = self._windows[op] = WindowedSketch(
                    self.alpha, self.window_s
                )
        w.add(seconds)

    def merged(self) -> dict[str, Sketch]:
        """{op: windowed Sketch} — the live window, one Sketch per class."""
        with self._lock:
            windows = dict(self._windows)
        return {op: w.merged() for op, w in windows.items()}

    def snapshot(self) -> dict[str, dict]:
        """{op: {count, p50_ms, p90_ms, p99_ms, ...}} over the window."""
        return {op: sk.to_dict() for op, sk in self.merged().items()}

    def dump(self) -> bytes:
        return dump_sketches(self.merged())

    def dump_b64(self) -> str:
        """The binary dump as base64 text (for JSON transports)."""
        return base64.b64encode(self.dump()).decode()

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()

    def render(self) -> str:
        lines = [
            f"# HELP {self.name}_seconds {self.help}",
            f"# TYPE {self.name}_seconds summary",
        ]
        for op, sk in sorted(self.merged().items()):
            if sk.count == 0:
                continue
            for q in self.QUANTILES:
                labels = (("op", op), ("quantile", f"{q:g}"))
                lines.append(
                    f"{self.name}_seconds{stats._fmt_labels(labels)} "
                    f"{sk.quantile(q):.6g}"
                )
            key = (("op", op),)
            lines.append(
                f"{self.name}_seconds_sum{stats._fmt_labels(key)} {sk.sum:.6g}"
            )
            lines.append(
                f"{self.name}_seconds_count{stats._fmt_labels(key)} {sk.count}"
            )
        return "\n".join(lines)


OP_LATENCY = SketchFamily(
    "weedtpu_op_latency",
    "Per-op-class request latency over the sliding window, as a mergeable "
    "DDSketch rendered to summary quantiles",
)


def record(op: str, seconds: float) -> None:
    """Record into the process-wide op-latency sketch family."""
    OP_LATENCY.record(op, seconds)


def debug_snapshot() -> dict:
    """/debug/sketchz JSON body."""
    return {
        "alpha": OP_LATENCY.alpha,
        "window_s": OP_LATENCY.window_s,
        "ops": OP_LATENCY.snapshot(),
    }
