"""Per-matrix artefact cache of the kernels, metered: the port of
seaweedfs_tpu/ops/sched_cache.py.

Survivor patterns repeat across rebuilds (RS(10,4) has at most C(14,10) =
1001 of them), so what a kernel needs per matrix is cached process-wide,
keyed on the matrix bytes, and
``weedtpu_ec_sched_cache_total{plane, event}`` (event: hit | miss) says
whether rebuilds ride the cache.  The port compiles nothing per matrix:
its kernels take the matrix as runtime data.  Its per-matrix artefacts are
the device copies that ops/rs_cuda uploads: K1's GF(2^8) matrix and K2's
packed GF(2) masks.  So the label set of ``plane`` is {cuda}, where the
JAX package has {pallas, jax, host}; the plain PyTorch path on the CPU
caches nothing and counts nothing.

Builds happen outside the cache lock (a concurrent duplicate build is
benign: last insert wins, both callers get a working value).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from seaweedfs_tpu_torch import stats

SCHED_CACHE_EVENTS = stats.Counter(
    "weedtpu_ec_sched_cache_total",
    "EC schedule/kernel compilation cache events by plane "
    "(hit = compiled schedule reused for a repeated matrix, miss = fresh "
    "compile)",
)

_MAXSIZE = 512  # about all RS(10,4) survivor patterns, with room for LRC plans


class _PlaneCache:
    def __init__(self, plane: str, maxsize: int = _MAXSIZE):
        self.plane = plane
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._items: OrderedDict = OrderedDict()

    def get_or_build(self, key, build):
        with self._lock:
            hit = key in self._items
            if hit:
                self._items.move_to_end(key)
                value = self._items[key]
        SCHED_CACHE_EVENTS.inc(plane=self.plane, event="hit" if hit else "miss")
        if hit:
            return value
        value = build()
        with self._lock:
            self._items[key] = value
            self._items.move_to_end(key)
            while len(self._items) > self.maxsize:
                self._items.popitem(last=False)
        return value

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


_caches: dict[str, _PlaneCache] = {}
_caches_lock = threading.Lock()


def _plane(plane: str) -> _PlaneCache:
    with _caches_lock:
        cache = _caches.get(plane)
        if cache is None:
            cache = _caches[plane] = _PlaneCache(plane)
        return cache


def get_or_build(plane: str, key, build):
    """Return the cached artefact for ``key`` on ``plane``, building (and
    counting a miss) when absent."""
    return _plane(plane).get_or_build(key, build)


def cache_clear(plane: str | None = None) -> None:
    """Drop cached artefacts; the counters are cumulative and stay."""
    with _caches_lock:
        if plane is None:
            caches = list(_caches.values())
        else:
            caches = [_caches[plane]] if plane in _caches else []
    for cache in caches:
        cache.clear()


def snapshot() -> dict[str, dict[str, float]]:
    """{plane: {hit, miss}}: the counter by plane."""
    out: dict[str, dict[str, float]] = {}
    for key, value in SCHED_CACHE_EVENTS.series().items():
        labels = dict(key)
        out.setdefault(labels.get("plane", "?"), {"hit": 0.0, "miss": 0.0})[
            labels.get("event", "?")
        ] = value
    return out
