"""Metrics: the port's counterpart of seaweedfs_tpu/stats.

Only the counter families the port emits so far, with the JAX package's
names and help strings: the repair budget's (ops/repair_budget), the
plane billing's (stats/plane) and, in ops/sched_cache, the schedule
cache's.  There is no ``/metrics`` endpoint yet (it comes with the
servers); ``series()`` is how callers read a family.
"""

from __future__ import annotations

import threading


class Counter:
    """A monotonically increasing family of label series."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

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
