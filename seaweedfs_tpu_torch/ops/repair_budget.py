"""Bandwidth-budgeted repair: the port of seaweedfs_tpu/ops/repair_budget.py.

Repair traffic competes with foreground reads for the same disks and
links, and an unthrottled rebuild storm is an outage.  This module is the
one place repair byte movement is (a) bounded: a token bucket refilled at
``WEED_REPAIR_RATE_MB`` MB/s (0 or unset = unlimited) that the EC rebuild
(storage/erasure_coding/ec_encoder.rebuild_ec_files) consults before
reading each chunk, and (b) accounted:
``weedtpu_repair_bytes_total{code,mode,dir}`` splits traffic by storage
class (rs | lrc), repair mode (local | global) and direction (read |
moved).  The bucket is process-wide.
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.util.limiter import TokenBucket


class RepairBudget:
    """The repair-traffic TokenBucket and the metrics funnel."""

    def __init__(self, rate_mb_s: float | None = None):
        if rate_mb_s is None:
            rate_mb_s = float(os.environ.get("WEED_REPAIR_RATE_MB", "0") or 0)
        self.rate_bytes_s = rate_mb_s * 1024 * 1024
        self._bucket = TokenBucket(self.rate_bytes_s)
        self._lock = threading.Lock()
        self._waited_s = 0.0

    def throttle(self, nbytes: int, wait=None) -> float:
        """Charge ``nbytes`` against the budget (TokenBucket.throttle);
        waited seconds are summed into weedtpu_repair_wait_seconds_total."""
        slept = self._bucket.throttle(nbytes, wait=wait)
        if slept > 0:
            stats.REPAIR_WAIT_SECONDS.inc(slept)
            with self._lock:
                self._waited_s += slept
        return slept

    def account(self, code: str, mode: str, read: int = 0, moved: int = 0) -> None:
        """Record one repair's traffic: ``read`` = bytes read from surviving
        shards, ``moved`` = bytes shipped cross-server."""
        if read:
            stats.REPAIR_BYTES.inc(read, code=code, mode=mode, dir="read")
        if moved:
            stats.REPAIR_BYTES.inc(moved, code=code, mode=mode, dir="moved")
        stats.REPAIR_OPS.inc(code=code, mode=mode)

    def snapshot(self) -> dict:
        with self._lock:
            waited = self._waited_s
        with self._bucket._lock:
            budget_bytes = self._bucket._budget
        return {
            "rate_mb_s": self.rate_bytes_s / 1024 / 1024,
            "budget_bytes": budget_bytes,
            "waited_s": waited,
            "bytes": {
                "{" + ",".join(f"{k}={v}" for k, v in key) + "}": val
                for key, val in sorted(stats.REPAIR_BYTES.series().items())
            },
            "ops": {
                "{" + ",".join(f"{k}={v}" for k, v in key) + "}": val
                for key, val in sorted(stats.REPAIR_OPS.series().items())
            },
        }


_shared: RepairBudget | None = None
_shared_lock = threading.Lock()


def shared() -> RepairBudget:
    """The process-wide budget (rate read from WEED_REPAIR_RATE_MB at
    first use; :func:`reload` re-reads it)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = RepairBudget()
        return _shared


def reload() -> RepairBudget:
    global _shared
    with _shared_lock:
        _shared = RepairBudget()
        return _shared


def snapshot() -> dict:
    """The shared budget and the repair counters."""
    return shared().snapshot()
