"""Per-peer circuit breakers and the breaker-ranked holder order.

The part of seaweedfs_tpu/util/resilience.py that the EC holder chain
(server/store_ec.py) reads: the policy's deadline and breaker settings
(``WEED_RPC_DEADLINE``, ``WEED_RPC_BREAKER_THRESHOLD``,
``WEED_RPC_BREAKER_COOLDOWN``), consecutive-failure ``CircuitBreaker``s
with a single half-open probe, the process-wide registry, the status-code
decision tree that feeds them (``note_rpc_outcome``) and
``rank_by_breaker``.  The port's rpc.py is plain grpcio, so the breakers
are fed by their callers (the EC shard reads).  Retries, default unary
deadlines, failover groups, the breaker metrics and trace spans are not
ported.
"""

from __future__ import annotations

import os
import threading
import time

import grpc


class Policy:
    """Resolved deadline/breaker settings (env-overridable)."""

    def __init__(self, deadline_s: float = 15.0, breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0):
        self.deadline_s = deadline_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s

    @classmethod
    def from_env(cls) -> "Policy":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default

        return cls(
            deadline_s=_f("WEED_RPC_DEADLINE", 15.0),
            breaker_threshold=max(1, int(_f("WEED_RPC_BREAKER_THRESHOLD", 5))),
            breaker_cooldown_s=_f("WEED_RPC_BREAKER_COOLDOWN", 5.0),
        )


_policy: Policy | None = None
_policy_lock = threading.Lock()


def policy() -> Policy:
    global _policy
    if _policy is None:
        with _policy_lock:
            if _policy is None:
                _policy = Policy.from_env()
    return _policy


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(self, peer: str, pol: Policy | None = None):
        self.peer = peer
        self._pol = pol
        self._lock = threading.Lock()
        self.state = "closed"
        self.failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        self._probe_started = 0.0

    def _p(self) -> Policy:
        return self._pol or policy()

    def _probe_stale_locked(self) -> bool:
        """A probe older than deadline+cooldown is considered lost."""
        p = self._p()
        return (self._probe_in_flight
                and time.monotonic() - self._probe_started > p.deadline_s + p.breaker_cooldown_s)

    def available(self) -> bool:
        """Non-consuming peek (rank_by_breaker uses it)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return time.monotonic() - self._opened_at >= self._p().breaker_cooldown_s
            return not self._probe_in_flight or self._probe_stale_locked()

    def record_success(self) -> None:
        """The peer answered, including with an application error."""
        with self._lock:
            self.failures = 0
            self._probe_in_flight = False
            self.state = "closed"

    def release_probe(self) -> None:
        """Give the half-open probe slot back without a verdict."""
        with self._lock:
            self._probe_in_flight = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == "half_open":
                self._probe_in_flight = False
                self._opened_at = time.monotonic()
                self.state = "open"
            elif self.state == "closed" and self.failures >= self._p().breaker_threshold:
                self._opened_at = time.monotonic()
                self.state = "open"


class BreakerRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def get(self, peer: str) -> CircuitBreaker | None:
        """Breaker for ``peer`` (created on first use); None for unnamed
        peers: a shared breaker would couple unrelated endpoints."""
        if not peer:
            return None
        with self._lock:
            br = self._breakers.get(peer)
            if br is None:
                br = self._breakers[peer] = CircuitBreaker(peer)
            return br


breakers = BreakerRegistry()


def note_rpc_outcome(br: CircuitBreaker | None, code, *, on_deadline: str) -> None:
    """Feed one RPC error's status code to a breaker: UNAVAILABLE always
    counts against the peer; any other answer proves liveness;
    DEADLINE_EXCEEDED does what ``on_deadline`` says ("failure",
    "success" or "release")."""
    if br is None:
        return
    if code is grpc.StatusCode.UNAVAILABLE:
        br.record_failure()
    elif code is grpc.StatusCode.DEADLINE_EXCEEDED:
        {"failure": br.record_failure, "success": br.record_success,
         "release": br.release_probe}[on_deadline]()
    else:
        br.record_success()


def rank_by_breaker(addresses) -> list:
    """Peers ordered breaker-available first: an open breaker means the
    last N calls there failed, so try those peers last."""
    return sorted(addresses,
                  key=lambda a: (br := breakers.get(a)) is not None and not br.available())
