"""Load limiting: the port's copy of seaweedfs_tpu/util/limiter.py.

- ``InFlightLimiter``: the volume server's upload and download
  backpressure.
- ``TokenBucket``: the one bucket; the repair budget (ops/repair_budget)
  composes it, and ``try_charge`` is the non-blocking admission probe.
- ``TenantQos``: per-tenant and per-bucket QoS for the S3 gateway, op-rate
  limits and write quotas that shed with 429 + Retry-After before the
  filer queues.  Its JSON config is static, or polled from the filer at
  ``QOS_CONFIG_PATH`` (the ``s3.qos`` shell command writes it):

      {"default":  {"opsPerSec": 200, "burst": 400},
       "tenants":  {"ak-heavy": {"opsPerSec": 50}},
       "buckets":  {"b1": {"opsPerSec": 100, "quotaBytes": 1048576,
                           "quotaObjects": 1000}}}

  Decisions land in ``weedtpu_qos_requests_total{scope,outcome}`` and
  ``weedtpu_qos_retry_after_seconds_total{scope}``.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

# where the S3 gateways poll the TenantQos document (the s3.qos shell
# command writes it; same contract as the circuit breaker's config)
QOS_CONFIG_PATH = "/etc/s3/qos.json"


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

    def try_charge(self, n: float = 1.0) -> float:
        """Non-blocking admission: charge ``n`` and return 0.0 when the
        budget covers it, else charge NOTHING and return the seconds
        until it would (the Retry-After a shed response carries).
        Unlimited (rate <= 0) always admits."""
        if self.rate_bytes_s <= 0 or n <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            if self._budget >= n:
                self._budget -= n
                return 0.0
            return (n - self._budget) / self.rate_bytes_s


@dataclass
class QosLimits:
    """One scope's parsed limits; 0 = unlimited."""

    ops_per_s: float = 0.0
    burst: float = 0.0  # defaults to ops_per_s when unset
    quota_bytes: int = 0
    quota_objects: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "QosLimits":
        return cls(
            ops_per_s=float(d.get("opsPerSec", 0) or 0),
            burst=float(d.get("burst", 0) or 0),
            quota_bytes=int(d.get("quotaBytes", 0) or 0),
            quota_objects=int(d.get("quotaObjects", 0) or 0),
        )


@dataclass
class Admission:
    """One admission decision.  ``ok`` admits; otherwise ``scope``
    ("tenant" | "bucket") and ``limit`` ("ops" | "quota_bytes" |
    "quota_objects") say what tripped and ``retry_after`` how long the
    client should back off (0 for quota — waiting won't help)."""

    ok: bool
    scope: str = ""
    limit: str = ""
    retry_after: float = 0.0


class TenantQos:
    """Per-tenant + per-bucket admission control.

    Both scopes must admit.  Rate buckets are minted lazily per key and
    swap ONLY when that key's configured limits change, so a config
    poll cannot hand a burst window back to a tenant mid-storm.  A
    tenant/bucket with no explicit entry rides ``default`` (still one
    bucket PER KEY — the default is a per-tenant rate, not a shared
    global one)."""

    # gates are keyed on UNAUTHENTICATED request strings (claimed access
    # key, bucket name in the URL) — the admission layer runs before
    # signature work by design, so the key space is attacker-controlled
    # and the table must be bounded.  LRU eviction: a re-minted gate
    # hands that key one fresh burst, which the burst already permits.
    GATE_CAPACITY = 4096

    def __init__(self, config: dict | None = None):
        from collections import OrderedDict

        self._lock = threading.Lock()
        self.enabled = False
        self._default = QosLimits()
        self._tenant_limits: dict[str, QosLimits] = {}
        self._bucket_limits: dict[str, QosLimits] = {}
        # (scope, key) -> (limits-in-force, TokenBucket), LRU-bounded
        self._gates: OrderedDict[
            tuple[str, str], tuple[QosLimits, TokenBucket]
        ] = OrderedDict()
        self.shed = 0
        if config:
            self.load(config)

    def load(self, config: dict | None) -> None:
        config = config or {}
        with self._lock:
            self._default = QosLimits.from_dict(config.get("default", {}))
            self._tenant_limits = {
                k: QosLimits.from_dict(v)
                for k, v in (config.get("tenants") or {}).items()
            }
            self._bucket_limits = {
                k: QosLimits.from_dict(v)
                for k, v in (config.get("buckets") or {}).items()
            }
            self.enabled = bool(
                config.get(
                    "enabled",
                    bool(
                        self._tenant_limits
                        or self._bucket_limits
                        or self._default != QosLimits()
                    ),
                )
            )

    def load_json(self, blob: bytes | str | None) -> None:
        import json

        if not blob:
            self.load({})
            return
        try:
            self.load(json.loads(blob))
        except (ValueError, TypeError, AttributeError):
            pass  # keep the last good config

    def _limits_for(self, scope: str, key: str) -> QosLimits:
        table = self._tenant_limits if scope == "tenant" else self._bucket_limits
        return table.get(key, self._default)

    def _gate(self, scope: str, key: str) -> tuple[QosLimits, TokenBucket | None]:
        with self._lock:
            lim = self._limits_for(scope, key)
            if lim.ops_per_s <= 0:
                return lim, None
            cur = self._gates.get((scope, key))
            if cur is None or cur[0] != lim:
                cur = (
                    lim,
                    TokenBucket(lim.ops_per_s, burst=lim.burst or lim.ops_per_s),
                )
                self._gates[(scope, key)] = cur
            self._gates.move_to_end((scope, key))
            while len(self._gates) > self.GATE_CAPACITY:
                self._gates.popitem(last=False)
            return cur

    def admit(
        self,
        tenant: str,
        bucket: str,
        *,
        n_ops: float = 1.0,
        write_bytes: int = 0,
        usage=None,
    ) -> Admission:
        """Admit one request for (tenant, bucket).

        ``usage`` — optional callable ``() -> (bytes, objects)`` giving
        the bucket's current usage; consulted lazily and only when the
        bucket carries a quota and the request writes (``write_bytes``
        >= 0 with a write op).  Quota rejections return retry_after 0 —
        the client must delete data, not slow down."""
        from seaweedfs_tpu_torch import stats

        if not self.enabled:
            return Admission(True)
        for scope, key in (("tenant", tenant), ("bucket", bucket)):
            if not key:
                continue
            lim, gate = self._gate(scope, key)
            if gate is not None:
                wait = gate.try_charge(n_ops)
                if wait > 0:
                    self.shed += 1
                    stats.QOS_REQUESTS.inc(scope=scope, outcome="shed_ops")
                    stats.QOS_WAIT_SECONDS.inc(wait, scope=scope)
                    return Admission(
                        False, scope=scope, limit="ops",
                        retry_after=max(wait, 0.05),
                    )
        if bucket and write_bytes >= 0 and usage is not None:
            lim = None
            with self._lock:
                blim = self._bucket_limits.get(bucket, self._default)
                if blim.quota_bytes or blim.quota_objects:
                    lim = blim
            if lim is not None:
                used_bytes, used_objects = usage()
                if lim.quota_bytes and used_bytes + max(write_bytes, 0) > lim.quota_bytes:
                    self.shed += 1
                    stats.QOS_REQUESTS.inc(scope="bucket", outcome="shed_quota")
                    return Admission(False, scope="bucket", limit="quota_bytes")
                if lim.quota_objects and used_objects + 1 > lim.quota_objects:
                    self.shed += 1
                    stats.QOS_REQUESTS.inc(scope="bucket", outcome="shed_quota")
                    return Admission(False, scope="bucket", limit="quota_objects")
        stats.QOS_REQUESTS.inc(scope="request", outcome="admitted")
        return Admission(True)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "shed": self.shed,
                "default": vars(self._default),
                "tenants": {k: vars(v) for k, v in self._tenant_limits.items()},
                "buckets": {k: vars(v) for k, v in self._bucket_limits.items()},
                "active_gates": len(self._gates),
            }


# ---- /debug/qos ----------------------------------------------------------

_debug_qos = None  # weakref to the process's TenantQos (one gateway/process)


def register_debug(qos: TenantQos) -> None:
    """Expose a TenantQos at /debug/qos (last caller wins — the
    one-server-per-process production shape, same contract as
    stats.SnapshotFamily providers)."""
    import weakref

    global _debug_qos
    _debug_qos = weakref.ref(qos)


def debug_snapshot() -> dict:
    qos = _debug_qos() if _debug_qos is not None else None
    return qos.snapshot() if qos is not None else {"enabled": False}
