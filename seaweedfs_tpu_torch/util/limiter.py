"""Load limiting: the port's copy of seaweedfs_tpu/util/limiter.py's
InFlightLimiter, the volume server's upload and download backpressure, and
TokenBucket, the bucket the repair budget (ops/repair_budget) composes.
The tenant QoS layer is not ported."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class InFlightLimiter:
    """Condition-variable backpressure on in-flight bytes (the reference
    volume server's upload/download limit,
    weed/server/volume_server_handlers_read.go:188-194)."""

    def __init__(self, limit_bytes: int, wait_timeout: float = 30.0):
        self.limit = limit_bytes
        self.wait_timeout = wait_timeout
        self._in_flight = 0
        self._cond = threading.Condition()

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    def acquire(self, n: int, timeout: float | None = None) -> bool:
        """Block until ``n`` more bytes fit under the limit; False on
        timeout.  A request larger than the whole limit is admitted once
        the pipe is empty (the reference waits on ``> limit``, it does not
        reject).  ``timeout`` overrides the limiter default: pass a small
        value when the caller already holds a reservation (growing while
        holding cannot wait long or peers in the same position starve each
        other)."""
        if self.limit <= 0 or n <= 0:  # limit 0 = disabled
            return True
        if timeout is not None:
            deadline = max(0.0, timeout)
        elif self.wait_timeout <= 0:
            deadline = threading.TIMEOUT_MAX
        else:
            deadline = self.wait_timeout
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._in_flight == 0 or self._in_flight + n <= self.limit,
                timeout=deadline,
            )
            if not ok:
                return False
            self._in_flight += n
            return True

    def release(self, n: int) -> None:
        if self.limit <= 0 or n <= 0:
            return
        with self._cond:
            self._in_flight = max(0, self._in_flight - n)
            self._cond.notify_all()

    @contextmanager
    def reserve(self, n: int, timeout: float | None = None):
        """Context-managed acquire/release; yields False if shed."""
        ok = self.acquire(n, timeout=timeout)
        try:
            yield ok
        finally:
            if ok:
                self.release(n)


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
