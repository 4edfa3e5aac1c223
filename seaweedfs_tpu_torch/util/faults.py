"""Deterministic fault injection for the gRPC layer and the disk seam.

The port's copy of seaweedfs_tpu/util/faults.py: tests and operators
prove the cluster degrades gracefully by injecting failures at the RPC
(rpc.py) and storage-backend (storage/backend.py) seams instead of hoping
production finds them first.  A *plan* is a list of
rules compiled from a spec string:

    WEED_FAULTS="volume:Read:unavailable:0.5,master:*:delay:200ms"
    WEED_FAULTS="disk:append:torn:0.3,disk:read_at:bitflip:0.01"

Grammar (fields separated by ``:``, one rule per comma):

    rule    := target ":" method ":" kind (":" arg)*
    target  := [side "/"] service ["@" addr-glob]
    side    := "client" | "server"          (default: client)
    service := "master" | "volume" | "filer" | ... | "disk" | "*"
    method  := RPC method name (CamelCase, fnmatch globs ok) | "*"
    kind    := "unavailable"   fail with UNAVAILABLE
             | "deadline"      fail with DEADLINE_EXCEEDED
             | "error"         fail with INTERNAL
             | "delay"         sleep, then let the call through
             | "hang"          sleep long enough to trip the deadline
    arg     := <float>         probability in [0,1]   (default 1.0)
             | <int>"ms"/"s"   duration (delay/hang)  (default 100ms / 30s)
             | "x"<int>        stop firing after N injections

The ``disk`` service targets the storage backend (storage/backend.py)
instead of an RPC: ``method`` is the backend op (``append``,
``write_at``, ``read_at``, ``sync`` — fnmatch globs ok) and the kinds
model real disk failure modes:

    kind    := "torn"     append/write_at writes a strict prefix of the
                          record and then fails (crash mid-write)
             | "bitflip"  read_at returns data with one random bit flipped
                          (silent media corruption)
             | "eio"      the op raises OSError(EIO)
             | "enospc"   a write raises OSError(ENOSPC), nothing written
             | "short"    the first pwrite syscall of the op writes only a
                          prefix; the backend's short-write loop must finish
                          the record (the op still succeeds)

An addr-glob on a ``disk`` rule matches the file path, so
``disk@*.idx:append:eio`` fails only index appends.

Since rule fields are ``:``-separated and addresses contain ``:``, an
addr-glob writes ``#`` for ``:`` — ``volume@127.0.0.1#8080:*:unavailable``.

Randomness is a single seeded stream (``WEED_FAULTS_SEED``, default 0),
so a failing chaos run reproduces bit-for-bit under the same seed and
call order.  Injections count into ``weedtpu_faults_injected_total``
(/metrics) by site/service/kind.

The plan is process-global: :func:`configure` installs one
programmatically (tests), otherwise the env spec is compiled lazily on
first use.  With no spec, the fast path is one None-check per call.

The native data plane (native/dataplane.py) appends and reads volume files
without the backend, so it asks :func:`disk_armed` before it takes a volume
and listens (:func:`add_listener`) for plans installed later: while a
``disk`` rule is armed every volume stays on the backend these rules cover.
"""

from __future__ import annotations

import fnmatch
import os
import random
import re
import threading
import time
from dataclasses import dataclass, field

import grpc

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)$")
_LIMIT_RE = re.compile(r"^x(\d+)$")

_KINDS = {"unavailable", "deadline", "error", "delay", "hang"}

# disk-side kinds (storage/backend.py seam); op applicability is enforced
# at injection sites via the ``kinds`` filter of FaultPlan.pick so a
# ``disk:*:bitflip`` rule never turns an append into a bit flip
DISK_KINDS = {"torn", "bitflip", "eio", "enospc", "short"}

_KIND_CODES = {
    "unavailable": grpc.StatusCode.UNAVAILABLE,
    "deadline": grpc.StatusCode.DEADLINE_EXCEEDED,
    "error": grpc.StatusCode.INTERNAL,
}

_DEFAULT_DELAY = {"delay": 0.1, "hang": 30.0}


class FaultSpecError(ValueError):
    pass


class InjectedFault(grpc.RpcError):
    """Client-side injected failure; quacks like a real RpcError."""

    def __init__(self, code: grpc.StatusCode, detail: str):
        super().__init__(detail)
        self._code = code
        self._detail = detail

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._detail


@dataclass
class FaultRule:
    side: str  # "client" | "server" | "*"
    service: str  # service glob ("volume", "*")
    addr_glob: str  # "" matches any address
    method: str  # method glob ("Read", "*")
    kind: str
    probability: float = 1.0
    duration_s: float = 0.0
    limit: int = -1  # max injections, -1 unlimited
    fired: int = 0

    def matches(self, side: str, service: str, method: str, address: str) -> bool:
        if self.side not in ("*", side):
            return False
        if not fnmatch.fnmatchcase(service, self.service):
            return False
        if not fnmatch.fnmatchcase(method, self.method):
            return False
        if self.addr_glob and not fnmatch.fnmatchcase(
            address or "", self.addr_glob
        ):
            return False
        return self.limit < 0 or self.fired < self.limit

    def describe(self) -> str:
        # disk rules spell their side implicitly ("disk:append:torn"
        # round-trips through parse_spec; "disk/disk:..." would not)
        out = self.service if self.side == "disk" else f"{self.side}/{self.service}"
        if self.addr_glob:
            out += f"@{self.addr_glob.replace(':', '#')}"
        out += f":{self.method}:{self.kind}"
        if self.kind in _DEFAULT_DELAY:
            out += f":{self.duration_s:g}s"
        if self.probability < 1.0:
            out += f":{self.probability:g}"
        if self.limit >= 0:
            out += f":x{self.limit}"
        return out


def parse_spec(spec: str) -> list[FaultRule]:
    rules: list[FaultRule] = []
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) < 3:
            raise FaultSpecError(
                f"fault rule {raw!r}: need target:method:kind[:arg...]"
            )
        target, method, kind = parts[0], parts[1], parts[2]
        if kind not in _KINDS and kind not in DISK_KINDS:
            raise FaultSpecError(
                f"fault rule {raw!r}: unknown kind {kind!r} "
                f"(one of {sorted(_KINDS | DISK_KINDS)})"
            )
        side = "client"
        if "/" in target:
            side, target = target.split("/", 1)
            if side not in ("client", "server", "*"):
                raise FaultSpecError(
                    f"fault rule {raw!r}: side must be client|server|*"
                )
        addr_glob = ""
        if "@" in target:
            target, addr_glob = target.split("@", 1)
            addr_glob = addr_glob.replace("#", ":")
        if (target == "disk") != (kind in DISK_KINDS):
            raise FaultSpecError(
                f"fault rule {raw!r}: kind {kind!r} "
                + (
                    "requires the 'disk' target"
                    if kind in DISK_KINDS
                    else "does not apply to the 'disk' target"
                )
            )
        if target == "disk":
            side = "disk"  # backend ops, not an RPC direction
        rule = FaultRule(
            side=side,
            service=target or "*",
            addr_glob=addr_glob,
            method=method or "*",
            kind=kind,
            duration_s=_DEFAULT_DELAY.get(kind, 0.0),
        )
        for arg in parts[3:]:
            arg = arg.strip()
            if (m := _DURATION_RE.match(arg)) is not None:
                rule.duration_s = float(m.group(1)) * (
                    0.001 if m.group(2) == "ms" else 1.0
                )
            elif (m := _LIMIT_RE.match(arg)) is not None:
                rule.limit = int(m.group(1))
            else:
                try:
                    rule.probability = float(arg)
                except ValueError:
                    raise FaultSpecError(
                        f"fault rule {raw!r}: unparseable arg {arg!r}"
                    ) from None
                if not 0.0 <= rule.probability <= 1.0:
                    raise FaultSpecError(
                        f"fault rule {raw!r}: probability {arg} not in [0,1]"
                    )
        rules.append(rule)
    return rules


@dataclass
class FaultPlan:
    rules: list[FaultRule]
    seed: int = 0
    rng: random.Random = field(init=False)
    injected: int = field(default=0, init=False)

    def __post_init__(self):
        self.rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def pick(
        self,
        side: str,
        service: str,
        method: str,
        address: str,
        kinds: frozenset | set | None = None,
    ):
        """First matching rule that fires (probability roll under lock so
        the seeded stream is consumed in a stable order).  ``kinds``
        restricts to rules whose kind applies at this injection site."""
        with self._lock:
            for rule in self.rules:
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not rule.matches(side, service, method, address):
                    continue
                if rule.probability < 1.0 and self.rng.random() >= rule.probability:
                    continue
                rule.fired += 1
                self.injected += 1
                return rule
        return None

    def randint(self, lo: int, hi: int) -> int:
        """Seeded inclusive-range draw (torn-write lengths, bit positions)
        consumed from the same deterministic stream as the fire rolls."""
        with self._lock:
            return self.rng.randint(lo, hi)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [
                {"rule": r.describe(), "fired": r.fired} for r in self.rules
            ]


_plan_lock = threading.Lock()
_plan: FaultPlan | None = None
_plan_loaded = False
# callables told of every plan configure() or reset() installs
_listeners: list = []


def add_listener(fn) -> None:
    """Call ``fn(plan)`` (plan may be None) after each configure()/reset()."""
    _listeners.append(fn)


def remove_listener(fn) -> None:
    try:
        _listeners.remove(fn)
    except ValueError:
        pass


def _notify(plan) -> None:
    for fn in list(_listeners):
        try:
            fn(plan)
        except Exception as e:  # noqa: BLE001 — a listener must not break configure
            from seaweedfs_tpu_torch.util import wlog

            wlog.warning("faults: plan listener failed: %s", e)


_UNSET = object()


def disk_armed(plan=_UNSET) -> bool:
    """True when the active plan (or ``plan``) holds a ``disk`` rule."""
    if plan is _UNSET:
        plan = active()
    return plan is not None and any(r.side == "disk" for r in plan.rules)


def configure(spec: str | None, seed: int | None = None) -> FaultPlan | None:
    """Install a plan programmatically (None/"" clears).  Returns it."""
    global _plan, _plan_loaded
    with _plan_lock:
        if not spec:
            _plan = None
        else:
            if seed is None:
                seed = int(os.environ.get("WEED_FAULTS_SEED", "0") or 0)
            _plan = FaultPlan(parse_spec(spec), seed=seed)
        _plan_loaded = True
        plan = _plan
    _notify(plan)
    return plan


def reset() -> None:
    """Forget any plan; the env spec is re-read on next use."""
    global _plan, _plan_loaded
    with _plan_lock:
        _plan = None
        _plan_loaded = False
    _notify(active())


def active() -> FaultPlan | None:
    global _plan, _plan_loaded
    if _plan_loaded:
        return _plan
    with _plan_lock:
        if not _plan_loaded:
            spec = os.environ.get("WEED_FAULTS", "")
            if spec:
                seed = int(os.environ.get("WEED_FAULTS_SEED", "0") or 0)
                _plan = FaultPlan(parse_spec(spec), seed=seed)
            _plan_loaded = True
    return _plan


def _count(site: str, service: str, kind: str) -> None:
    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.stats import events

    stats.FAULTS_INJECTED.inc(site=site, service=service, kind=kind)
    # attr is `fault=`, not `kind=`: every event's `kind` is its event type
    events.record(
        events.FAULT_INJECTED, site=site, service=service, fault=kind
    )


def inject_client(
    service: str, method: str, address: str, timeout: float | None = None
) -> None:
    """Client-side hook (rpc.Stub): raise or delay per the active plan.

    ``hang`` emulates a black-holed peer faithfully: stall until the
    call's deadline (or the rule duration, whichever is shorter) and
    raise DEADLINE_EXCEEDED — what a real hung server produces —
    instead of stalling *before* the call and then granting it a fresh
    full deadline."""
    plan = active()
    if plan is None:
        return
    rule = plan.pick("client", service, method, address)
    if rule is None:
        return
    _count("client", service, rule.kind)
    if rule.kind == "delay":
        time.sleep(rule.duration_s)
        return
    if rule.kind == "hang":
        stall = rule.duration_s
        if timeout is not None:
            stall = min(stall, timeout)
        time.sleep(stall)
        raise InjectedFault(
            grpc.StatusCode.DEADLINE_EXCEEDED,
            f"injected hang ({service}.{method} @ {address or '?'})",
        )
    raise InjectedFault(
        _KIND_CODES[rule.kind],
        f"injected {rule.kind} ({service}.{method} @ {address or '?'})",
    )


def inject_server(service: str, method: str, context) -> None:
    """Server-side hook (rpc.add_service): abort or delay the handler."""
    plan = active()
    if plan is None:
        return
    rule = plan.pick("server", service, method, "")
    if rule is None:
        return
    _count("server", service, rule.kind)
    if rule.kind in ("delay", "hang"):
        time.sleep(rule.duration_s)
        return
    context.abort(
        _KIND_CODES[rule.kind], f"injected {rule.kind} ({service}.{method})"
    )


_DISK_READ_KINDS = frozenset({"bitflip", "eio"})
_DISK_WRITE_KINDS = frozenset({"torn", "eio", "enospc", "short"})
_DISK_SYNC_KINDS = frozenset({"eio"})

_DISK_OP_KINDS = {
    "read_at": _DISK_READ_KINDS,
    "append": _DISK_WRITE_KINDS,
    "write_at": _DISK_WRITE_KINDS,
    "sync": _DISK_SYNC_KINDS,
    "flush": _DISK_SYNC_KINDS,
}


def disk_fault(op: str, path: str):
    """Disk-seam hook (storage/backend.py): first firing ``disk`` rule
    whose kind applies to ``op``, or None.  The backend implements the
    kind's semantics (this module only decides *whether* and draws the
    seeded randomness); with no plan active the cost is one None-check."""
    plan = active()
    if plan is None:
        return None
    rule = plan.pick(
        "disk", "disk", op, path, kinds=_DISK_OP_KINDS.get(op, _DISK_SYNC_KINDS)
    )
    if rule is not None:
        _count("disk", "disk", rule.kind)
    return rule


def disk_randint(lo: int, hi: int) -> int:
    """Seeded draw for disk-fault shapes; falls back to a fixed midpoint
    with no plan (callers only reach this with a fired rule in hand)."""
    plan = active()
    if plan is None:
        return (lo + hi) // 2
    return plan.randint(lo, hi)


def snapshot() -> dict:
    """Plan state for /debug/faults."""
    plan = active()
    if plan is None:
        return {"active": False}
    return {
        "active": True,
        "seed": plan.seed,
        "injected": plan.injected,
        "rules": plan.snapshot(),
    }
