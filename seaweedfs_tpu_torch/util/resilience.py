"""RPC resilience: per-peer circuit breakers, bounded retries and failover
groups.

The port's copy of seaweedfs_tpu/util/resilience.py:

* **Policy** (env-overridable): the default unary deadline
  (``WEED_RPC_DEADLINE``), the retry budget (``WEED_RPC_MAX_ATTEMPTS``)
  with full-jitter exponential backoff (``WEED_RPC_BACKOFF_MS``,
  ``WEED_RPC_BACKOFF_MAX_MS``), the breakers' threshold and cooldown
  (``WEED_RPC_BREAKER_THRESHOLD``, ``WEED_RPC_BREAKER_COOLDOWN``) and the
  failover rotations (``WEED_RPC_FAILOVER_ROTATIONS``).
* **Circuit breakers**: consecutive-failure breakers with a single
  half-open probe, the process-wide registry, the status-code decision
  tree that feeds them (``note_rpc_outcome``) and ``rank_by_breaker``.
* **call_unary**: one re-runnable unary call under the breaker gate and
  the retry budget (UNAVAILABLE always retries, DEADLINE_EXCEEDED only for
  idempotent methods).
* **failover_call**: rotate a peer list (master HA) with jittered backoff
  between full rotations, peers with an unavailable breaker last.

Every stub built by rpc.py runs its unary calls through ``call_unary``
and gates its streams on the breakers; unary calls that pass no timeout
get the default deadline, except the heavyweight admin RPCs of
``NO_DEFAULT_DEADLINE``.  Breaker transitions surface in /metrics
(``weedtpu_rpc_breaker_*``), /debug/breakers (``snapshot``), the flight
recorder and, when a trace is active, as zero-length ``breaker.*`` spans;
a retry counts into ``weedtpu_rpc_client_retries_total`` and records a
``retry.<method>`` span.  With a fault plan active (util/faults.py) the
jitter draws from its seeded stream, so a failing run replays.
"""

from __future__ import annotations

import os
import random
import threading
import time

import grpc

from seaweedfs_tpu_torch.util import wlog

_CONNECTION_CODES = (
    grpc.StatusCode.UNAVAILABLE,
    grpc.StatusCode.DEADLINE_EXCEEDED,
)

_sleep = time.sleep  # monkeypatch seam for the tests


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


class Policy:
    """Resolved retry/deadline/breaker settings (env-overridable)."""

    def __init__(
        self,
        deadline_s: float = 15.0,
        max_attempts: int = 3,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 5.0,
        failover_rotations: int = 2,
    ):
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.failover_rotations = failover_rotations

    @classmethod
    def from_env(cls) -> "Policy":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default

        return cls(
            deadline_s=_f("WEED_RPC_DEADLINE", 15.0),
            max_attempts=max(1, int(_f("WEED_RPC_MAX_ATTEMPTS", 3))),
            backoff_base_s=_f("WEED_RPC_BACKOFF_MS", 50.0) / 1e3,
            backoff_max_s=_f("WEED_RPC_BACKOFF_MAX_MS", 2000.0) / 1e3,
            breaker_threshold=max(1, int(_f("WEED_RPC_BREAKER_THRESHOLD", 5))),
            breaker_cooldown_s=_f("WEED_RPC_BREAKER_COOLDOWN", 5.0),
            failover_rotations=max(1, int(_f("WEED_RPC_FAILOVER_ROTATIONS", 2))),
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


def reload_policy() -> Policy:
    """Re-read env overrides (tests tweak env, then call this)."""
    global _policy
    with _policy_lock:
        _policy = Policy.from_env()
    return _policy


_IDEMPOTENT_PREFIXES = ("Lookup", "Get", "List", "Read", "Stat", "Ping", "Collection")
_IDEMPOTENT_SUFFIXES = ("Status", "Info", "Read", "Query")

# explicit marks for methods the naming heuristic misses
IDEMPOTENT_METHODS: set[str] = {"Statistics", "VacuumVolumeCheck"}

# heavyweight admin operations whose runtime scales with volume size:
# they get NO default deadline (callers may still pass an explicit one)
NO_DEFAULT_DEADLINE: set[str] = {
    "EcShardsGenerate",
    "EcShardsRebuild",
    "EcShardsCopy",
    "EcShardsToVolume",
    "VolumeCopy",
    "VolumeVacuum",
    "VolumeTierMove",
    "VolumeScrub",  # CRC-walks every live needle of a volume
    "CopyFile",
}


def is_idempotent(method: str) -> bool:
    """Safe to re-run after a possible partial execution (reads/lookups)."""
    return (method in IDEMPOTENT_METHODS or method.startswith(_IDEMPOTENT_PREFIXES)
            or method.endswith(_IDEMPOTENT_SUFFIXES))


def _rng() -> random.Random:
    """Jitter stream: the seeded fault-plan RNG when a plan is active (so a
    failing run replays bit for bit), the global stream otherwise."""
    from seaweedfs_tpu_torch.util import faults

    plan = faults.active()
    return plan.rng if plan is not None else random  # type: ignore[return-value]


def backoff_s(attempt: int, pol: Policy | None = None) -> float:
    """Full-jitter exponential backoff for retry number ``attempt`` (1-based)."""
    pol = pol or policy()
    cap = min(pol.backoff_max_s, pol.backoff_base_s * (2 ** (attempt - 1)))
    return _rng().uniform(0.0, cap)


def error_code(e: Exception):
    code = getattr(e, "code", None)
    if callable(code):
        try:
            return code()
        except Exception as exc:  # noqa: BLE001 — malformed error object
            if wlog.V(2):
                wlog.info("rpc: unreadable status code on %r: %s", e, exc)
            return None
    return None


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


class CircuitOpenError(grpc.RpcError):
    """Fail-fast while a peer's breaker is open; quacks UNAVAILABLE so
    failover layers treat it like a connection failure."""

    def __init__(self, peer: str):
        super().__init__(f"circuit breaker open for {peer}")
        self.peer = peer

    def code(self) -> grpc.StatusCode:
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:
        return f"circuit breaker open for {self.peer}"


_STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


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
        """A probe older than deadline+cooldown is considered lost (its
        caller died without a verdict); the slot is reclaimable."""
        p = self._p()
        return (self._probe_in_flight
                and time.monotonic() - self._probe_started > p.deadline_s + p.breaker_cooldown_s)

    def _transition_locked(self, new_state: str) -> None:
        if new_state == self.state:
            return
        old, self.state = self.state, new_state
        from seaweedfs_tpu_torch import stats
        from seaweedfs_tpu_torch.stats import events, trace

        stats.RPC_BREAKER_TRANSITIONS.inc(peer=self.peer, to=new_state)
        stats.RPC_BREAKER_STATE.set(_STATE_VALUES[new_state], peer=self.peer)
        # flight recorder: one ring append, safe under the breaker lock
        events.record({"open": events.BREAKER_OPEN, "closed": events.BREAKER_CLOSE,
                       "half_open": events.BREAKER_HALF_OPEN}[new_state],
                      peer=self.peer, from_state=old, failures=self.failures)
        wlog.warning("breaker %s: %s -> %s (failures=%d)", self.peer, old, new_state,
                     self.failures)
        ctx = trace.current()
        if ctx is not None:
            trace.record_foreign_span(ctx.trace_id, ctx.span_id, f"breaker.{new_state}", "rpc",
                                      time.time(), 0.0,
                                      status="ok" if new_state == "closed" else "error",
                                      attrs={"peer": self.peer, "from": old})

    def allow(self) -> bool:
        """May a call proceed now?  Consumes the half-open probe slot."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.monotonic() - self._opened_at < self._p().breaker_cooldown_s:
                    return False
                self._transition_locked("half_open")
                self._probe_in_flight = True
                self._probe_started = time.monotonic()
                return True
            # half-open: one probe at a time (a stale slot is reclaimed)
            if self._probe_in_flight and not self._probe_stale_locked():
                return False
            self._probe_in_flight = True
            self._probe_started = time.monotonic()
            return True

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
            self._transition_locked("closed")

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
                self._transition_locked("open")
            elif self.state == "closed" and self.failures >= self._p().breaker_threshold:
                self._opened_at = time.monotonic()
                self._transition_locked("open")

    def snapshot(self) -> dict:
        with self._lock:
            return {"peer": self.peer, "state": self.state, "failures": self.failures}


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

    def snapshot(self) -> list[dict]:
        with self._lock:
            brs = list(self._breakers.values())
        return [b.snapshot() for b in brs]

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


breakers = BreakerRegistry()


def snapshot() -> list[dict]:
    """All breaker states, for /debug/breakers."""
    return breakers.snapshot()


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


# ---------------------------------------------------------------------------
# the resilient unary call and failover groups
# ---------------------------------------------------------------------------


def call_unary(invoke, *, service: str, method: str, address: str = "",
               max_attempts: int | None = None):
    """Run ``invoke()`` under the policy: breaker gate, bounded retries on
    connection-class codes, full-jitter backoff, breaker bookkeeping.
    ``invoke`` must be re-runnable (unary request)."""
    pol = policy()
    attempts_allowed = max_attempts if max_attempts is not None else pol.max_attempts
    idempotent = is_idempotent(method)
    br = breakers.get(address)
    attempt = 0
    while True:
        if br is not None and not br.allow():
            raise CircuitOpenError(address)
        attempt += 1
        try:
            resp = invoke()
        except grpc.RpcError as e:
            code = error_code(e)
            note_rpc_outcome(br, code, on_deadline="failure")
            retriable = code == grpc.StatusCode.UNAVAILABLE or (
                code == grpc.StatusCode.DEADLINE_EXCEEDED and idempotent)
            if not retriable or attempt >= attempts_allowed:
                raise
            from seaweedfs_tpu_torch import stats
            from seaweedfs_tpu_torch.stats import trace

            stats.RPC_CLIENT_RETRIES.inc(service=service, method=method, code=code.name)
            ctx = trace.current()
            if ctx is not None:
                trace.record_foreign_span(ctx.trace_id, ctx.span_id, f"retry.{method}", "rpc",
                                          time.time(), 0.0, status="error",
                                          attrs={"peer": address, "attempt": attempt,
                                                 "code": code.name})
            if wlog.V(1):
                wlog.info("rpc %s.%s @ %s: attempt %d/%d failed %s, retrying", service, method,
                          address, attempt, attempts_allowed, code.name)
            _sleep(backoff_s(attempt, pol))
            continue
        except BaseException:
            # the call died before reaching the peer (client-side bug): no
            # verdict, but a held half-open probe slot must come back
            if br is not None:
                br.release_probe()
            raise
        if br is not None:
            br.record_success()
        return resp


def failover_call(addresses, call_at, *, on_success=None, rotations: int | None = None):
    """Try ``call_at(addr)`` across a peer group (master HA rotation).

    Connection-class failures (UNAVAILABLE / DEADLINE_EXCEEDED) move to
    the next peer; application errors are the answer and raise
    immediately.  Peers with an unavailable breaker are tried last, and
    full rotations are separated by jittered backoff."""
    pol = policy()
    addresses = list(addresses)
    if not addresses:
        raise ValueError("failover_call: empty address list")
    rotations = rotations if rotations is not None else pol.failover_rotations
    last_err: Exception | None = None
    for rotation in range(rotations):
        if rotation:
            _sleep(backoff_s(rotation, pol))
        for addr in rank_by_breaker(addresses):
            try:
                resp = call_at(addr)
            except grpc.RpcError as e:
                if error_code(e) not in _CONNECTION_CODES:
                    raise
                last_err = e
                continue
            if on_success is not None:
                on_success(addr)
            return resp
    assert last_err is not None
    raise last_err
