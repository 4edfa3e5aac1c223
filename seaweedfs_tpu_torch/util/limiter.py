"""Rate limiting: the port's copy of seaweedfs_tpu/util/limiter.py's
TokenBucket, the bucket the repair budget (ops/repair_budget) composes."""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Rate token bucket, stop-responsive.

    ``burst`` defaults to 1 s of rate.  Sleeping happens OUTSIDE the lock
    so concurrent paths account in parallel, and the whole deficit is
    slept off in <= 5 s slices (a single capped sleep would let large
    charges, such as a rebuild chunk of n_in x 64 MiB, sustain a multiple
    of the configured rate).
    """

    def __init__(self, rate_per_s: float, burst: float | None = None):
        self.rate_bytes_s = rate_per_s  # the JAX package's name; unit is the caller's
        self.burst = rate_per_s if burst is None else burst
        self._lock = threading.Lock()
        self._budget = self.burst
        self._last = time.monotonic()

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._budget = min(
            self._budget + (now - self._last) * self.rate_bytes_s, self.burst
        )
        self._last = now

    def throttle(self, nbytes: int, wait=None) -> float:
        """Charge ``nbytes``; sleep off any deficit.  ``wait`` replaces
        time.sleep (pass a stop event's ``wait`` so shutdown is not pinned
        in a throttle sleep; a truthy return ends the throttle early).
        Returns the seconds actually waited."""
        if self.rate_bytes_s <= 0 or nbytes <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            self._budget -= nbytes
            deficit = -self._budget
        if deficit <= 0:
            return 0.0
        t0 = time.monotonic()
        remaining = deficit / self.rate_bytes_s
        while remaining > 0:
            step = min(remaining, 5.0)
            stopped = (wait or time.sleep)(step)
            remaining -= step
            if stopped:
                break  # the caller is shutting down
        # measured, not nominal: an early-fired stop event returns at once
        # and must not overstate the throttling
        return time.monotonic() - t0
