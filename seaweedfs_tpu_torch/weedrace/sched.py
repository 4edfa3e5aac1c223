"""Deterministic cooperative scheduler + preemption-bounded exploration:
the port of the weedrace explorer's scheduler (weedrace/sched.py).

The :class:`SchedulerGate` serializes a set of *controlled* threads onto
one runnable-at-a-time token.  It plugs into the
:mod:`seaweedfs_tpu_torch.util.sync_seam` gate hook: every blocking operation
an instrumented primitive performs on a controlled thread — lock
acquire, ``queue.Queue`` put/get, ``Event.wait``, ``Thread.join`` —
becomes a *scheduling point* where the thread parks and the scheduler
picks who runs next.  Blocking is replaced by try-operations, so an
explored run can never truly deadlock: a thread whose try fails parks as
*blocked* and is reconsidered when any release/set/put bumps the wake
version.  When nothing is runnable:

* blocked operations that carry a timeout "time out" (lowest thread
  first — the model is that time only advances when no thread can run);
* otherwise the run records a **deadlock finding** and aborts.

Determinism: a run is reproduced exactly by its *schedule* — the list of
choice indices taken at decision points (points with >1 runnable
thread).  :func:`explore` DFS-enumerates schedules up to a preemption
bound (default 2): a preemption is choosing a different thread while the
previously running one is still runnable.  ``WEED_RACECHECK_SCHEDULE``
(comma-separated indices) replays one schedule instead of exploring.

Uncontrolled threads (pool workers, background daemons) keep running on
real primitives; they are outside the schedule but cannot corrupt it —
controlled threads only ever advance when granted.

Limitation: ``Condition.wait`` on an instrumented lock parks on a raw C
waiter lock the gate cannot intercept; it serializes through real
blocking instead of a scheduling point.  Protocol scenarios stick to
Lock/RLock/Event/Queue/join, which cover the repo's delicate state
machines.
"""

from __future__ import annotations

import os
import queue as _queue_mod
import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.util import sync_seam

REAL_LOCK = sync_seam.REAL_LOCK
# the real join/put/get, read from the seam at each call (the seam takes
# them when it installs)
_REAL_THREAD_JOIN = sync_seam.real_thread_join
_REAL_QUEUE_PUT = sync_seam.real_queue_put
_REAL_QUEUE_GET = sync_seam.real_queue_get

SCHEDULE_ENV = "WEED_RACECHECK_SCHEDULE"
DEFAULT_PREEMPTION_BOUND = 2


class Abort(BaseException):
    """Raised inside controlled threads when a run is torn down."""


class _TRec:
    __slots__ = (
        "thread", "index", "name", "state", "active", "granted",
        "timed_out", "timeout_capable", "block_version", "desc",
    )

    def __init__(self, thread, index, name):
        self.thread = thread
        self.index = index
        self.name = name
        self.state = "new"  # new|ready|running|blocked|done
        self.active = False  # gate only controls threads past _enter()
        self.granted = False
        self.timed_out = False
        self.timeout_capable = False
        self.block_version = -1
        self.desc = ""


@dataclass
class RunResult:
    schedule: tuple  # prescribed prefix this run was started with
    decisions: list = field(default_factory=list)
    schedule_used: tuple = ()  # full choice list (replays this run)
    races: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    deadlock: list | None = None
    aborted: bool = False


class SchedulerGate:
    """One run's cooperative scheduler; install with sync_seam.set_gate."""

    def __init__(self, schedule=None, watchdog_s: float = 30.0):
        self._cv = threading.Condition(REAL_LOCK())
        self._recs: dict = {}  # Thread -> _TRec
        self._order: list = []  # _TRec, registration order
        self._schedule = list(schedule or [])
        self.decisions: list = []  # dicts: choice/n/last_pos/preempt
        self.errors: list = []
        self.deadlock: list | None = None
        self.version = 0  # bumped on every release/set/put/get/done
        self._aborted = False
        self._last_ran: int | None = None
        self._watchdog_s = watchdog_s
        self._wake_listener = _WakeListener(self)

    # -- scenario-facing API ------------------------------------------------

    def spawn(self, fn, name: str):
        """Register a controlled thread running ``fn`` (not started yet)."""
        index = len(self._order)

        def _body():
            rec = self._recs[threading.current_thread()]
            try:
                self._enter(rec)
                fn()
            except Abort:
                pass
            except BaseException as e:  # noqa: BLE001 - recorded, not lost
                self.errors.append((name, repr(e)))
            finally:
                self._finish(rec)

        t = threading.Thread(target=_body, name=f"weedrace-{name}", daemon=True)
        rec = _TRec(t, index, name)
        self._recs[t] = rec
        self._order.append(rec)
        return t

    def run(self) -> None:
        """Start every spawned thread and schedule until all finish."""
        sync_seam.add_listener(self._wake_listener)
        sync_seam.set_gate(self)
        try:
            for rec in self._order:
                rec.thread.start()
            self._loop()
        finally:
            sync_seam.set_gate(None)
            sync_seam.remove_listener(self._wake_listener)
            for rec in self._order:
                _REAL_THREAD_JOIN(rec.thread, 5.0)
                if not rec.thread.is_alive():
                    # the real join bypasses the seam: emit the HB edge so
                    # code after run() (checks, the next explored run) is
                    # ordered after everything the dead thread did
                    sync_seam._emit("thread_joined", None, rec.thread)
        self.decisions_used()

    def decisions_used(self) -> tuple:
        return tuple(d["choice"] for d in self.decisions)

    # -- seam gate interface ------------------------------------------------

    def controls(self, thread) -> bool:
        rec = self._recs.get(thread)
        return rec is not None and rec.active

    def lock_acquire(self, wrapper, blocking, timeout) -> bool:
        inner = wrapper._inner
        if not blocking:
            self._park(desc=f"trylock {wrapper._site}")
            return inner.acquire(False)
        capable = timeout is not None and timeout >= 0
        while True:
            self._park(desc=f"lock {wrapper._site}")
            if inner.acquire(False):
                return True
            if self._block(desc=f"lock {wrapper._site}", timeout_capable=capable):
                return False  # timed out

    def lock_released(self, wrapper) -> None:
        self._bump()

    def lock_wait_reacquire(self, wrapper, inner_state) -> None:
        # Condition.wait re-taking the wrapped lock: cooperative retry
        # (the inner_state of a Lock-backed condition is None; RLock
        # state must be restored for reentrancy counts)
        inner = wrapper._inner
        while True:
            self._park(desc=f"reacquire {wrapper._site}")
            if hasattr(inner, "_acquire_restore"):
                if inner.acquire(False):
                    inner.release()
                    inner._acquire_restore(inner_state)
                    return
            elif inner.acquire(False):
                return
            self._block(desc=f"reacquire {wrapper._site}", timeout_capable=False)

    def event_wait(self, event, timeout) -> bool:
        capable = timeout is not None
        while True:
            self._park(desc="event.wait")
            if event.is_set():
                return True
            if self._block(desc="event.wait", timeout_capable=capable):
                return False

    def queue_put(self, q, item, block, timeout):
        capable = block and timeout is not None
        while True:
            self._park(desc="queue.put")
            try:
                return _REAL_QUEUE_PUT(q, item, block=False)
            except _queue_mod.Full:
                if not block:
                    raise
                if self._block(desc="queue.put", timeout_capable=capable):
                    raise _queue_mod.Full from None

    def queue_get(self, q, block, timeout):
        capable = block and timeout is not None
        while True:
            self._park(desc="queue.get")
            try:
                return _REAL_QUEUE_GET(q, block=False)
            except _queue_mod.Empty:
                if not block:
                    raise
                if self._block(desc="queue.get", timeout_capable=capable):
                    raise _queue_mod.Empty from None

    def join_thread(self, thread, timeout) -> None:
        capable = timeout is not None
        while True:
            self._park(desc=f"join {thread.name}")
            rec = self._recs.get(thread)
            if rec is not None:
                if rec.state == "done":
                    _REAL_THREAD_JOIN(thread, 5.0)
                    return
            elif not thread.is_alive():
                return
            if self._block(desc=f"join {thread.name}", timeout_capable=capable):
                return  # join timeout: caller re-checks is_alive()

    # -- thread lifecycle ---------------------------------------------------

    def _enter(self, rec) -> None:
        with self._cv:
            rec.active = True
        self._park(desc="start")

    def _finish(self, rec) -> None:
        with self._cv:
            rec.state = "done"
            rec.active = False
            self.version += 1
            self._cv.notify_all()

    # -- parking ------------------------------------------------------------

    def _park(self, desc: str) -> None:
        """Scheduling point: wait until granted the token."""
        rec = self._recs[threading.current_thread()]
        with self._cv:
            rec.state = "ready"
            rec.desc = desc
            self._cv.notify_all()
            while not rec.granted:
                if self._aborted:
                    raise Abort()
                self._cv.wait(1.0)
            rec.granted = False
            rec.state = "running"
            self._cv.notify_all()  # scheduler: grant consumed

    def _block(self, desc: str, timeout_capable: bool) -> bool:
        """Park as blocked (try-op failed); True when woken by timeout."""
        rec = self._recs[threading.current_thread()]
        with self._cv:
            rec.state = "blocked"
            rec.desc = desc
            rec.timeout_capable = timeout_capable
            rec.block_version = self.version
            rec.timed_out = False
            self._cv.notify_all()
            while not rec.granted:
                if self._aborted:
                    raise Abort()
                self._cv.wait(1.0)
            rec.granted = False
            rec.state = "running"
            self._cv.notify_all()  # scheduler: grant consumed
            return rec.timed_out

    def _bump(self) -> None:
        with self._cv:
            self.version += 1
            self._cv.notify_all()

    # -- the scheduler loop -------------------------------------------------

    def _loop(self) -> None:
        deadline = time.monotonic() + self._watchdog_s
        with self._cv:
            while True:
                live = [r for r in self._order if r.state != "done"]
                if not live:
                    return
                parked = [
                    r for r in live
                    if r.state in ("ready", "blocked") and not r.granted
                ]
                if len(parked) < len(live):
                    # someone holds the token (granted, not yet woken) or
                    # is running real code / bootstrapping: release _cv
                    # and wait — parked threads can only wake while the
                    # scheduler is inside this wait
                    self._cv.wait(0.2)
                    if time.monotonic() > deadline:
                        self.errors.append(("scheduler", "watchdog expired"))
                        self._abort_locked()
                        return
                    continue
                runnable = [
                    r for r in parked
                    if r.state == "ready"
                    or (r.state == "blocked" and r.block_version < self.version)
                ]
                if not runnable:
                    timeoutable = [r for r in parked if r.timeout_capable]
                    if timeoutable:
                        r = timeoutable[0]
                        r.timed_out = True
                        r.granted = True
                        self._cv.notify_all()
                        continue
                    # grace window: an uncontrolled thread (pool worker,
                    # a spawned thread's bootstrap) may be about to bump
                    v0 = self.version
                    self._cv.wait(0.3)
                    if self.version != v0:
                        continue
                    self.deadlock = [f"{r.name}: {r.desc}" for r in parked]
                    self._abort_locked()
                    return
                choice = self._choose(runnable)
                rec = runnable[choice]
                self._last_ran = rec.index
                rec.granted = True
                self._cv.notify_all()

    def _choose(self, runnable) -> int:
        if len(runnable) == 1:
            return 0
        last_pos = next(
            (i for i, r in enumerate(runnable) if r.index == self._last_ran),
            None,
        )
        k = len(self.decisions)
        if k < len(self._schedule):
            choice = min(max(int(self._schedule[k]), 0), len(runnable) - 1)
        elif last_pos is not None:
            choice = last_pos  # default: keep running, no preemption
        else:
            choice = 0
        self.decisions.append({
            "choice": choice,
            "n": len(runnable),
            "last_pos": last_pos,
            "preempt": last_pos is not None and choice != last_pos,
            "threads": [r.name for r in runnable],
        })
        return choice

    def _abort_locked(self) -> None:
        self._aborted = True
        for r in self._order:
            r.granted = True
        self._cv.notify_all()


# -- wake listener (sees events from uncontrolled threads too) --------------


class _WakeListener:
    """Seam listener bumping the gate's wake version on state changes."""

    def __init__(self, gate: SchedulerGate):
        self._gate = gate

    def lock_released(self, lock, site, held_for, reentry):
        self._gate._bump()

    def lock_wait_release(self, lock):
        self._gate._bump()

    def event_set(self, event):
        self._gate._bump()

    def queue_put(self, q):
        self._gate._bump()

    def queue_get(self, q):
        self._gate._bump()

    def thread_run_end(self, thread):
        self._gate._bump()


# -- exploration ------------------------------------------------------------


def run_schedule(scenario, schedule=()) -> RunResult:
    """One run of ``scenario`` under a prescribed schedule prefix.

    ``scenario`` is a callable taking the gate; it builds state, spawns
    controlled threads via ``gate.spawn``, and may return a zero-arg
    ``check()`` run after the schedule completes (assertion failures are
    recorded as errors)."""
    from seaweedfs_tpu_torch.util import racecheck

    races_before = len(racecheck._races) if racecheck.is_installed() else 0
    gate = SchedulerGate(schedule=schedule)
    check = scenario(gate)
    gate.run()
    result = RunResult(schedule=tuple(schedule))
    result.decisions = gate.decisions
    result.schedule_used = gate.decisions_used()
    result.errors = list(gate.errors)
    result.deadlock = gate.deadlock
    result.aborted = gate._aborted
    if check is not None and not gate._aborted:
        try:
            check()
        except AssertionError as e:
            result.errors.append(("check", f"invariant failed: {e}"))
    if racecheck.is_installed():
        with racecheck._mu:
            result.races = list(racecheck._races[races_before:])
    return result


def _preemptions(decisions, upto: int) -> int:
    return sum(1 for d in decisions[:upto] if d["preempt"])


def explore(
    scenario,
    bound: int = DEFAULT_PREEMPTION_BOUND,
    max_runs: int = 64,
    schedule=None,
) -> list[RunResult]:
    """DFS over preemption-bounded schedules of ``scenario``.

    ``schedule`` (or ``WEED_RACECHECK_SCHEDULE`` in the environment)
    short-circuits exploration to a single replayed schedule."""
    if schedule is None:
        env = os.environ.get(SCHEDULE_ENV, "").strip()
        if env:
            schedule = [int(x) for x in env.split(",") if x.strip()]
    if schedule is not None:
        return [run_schedule(scenario, tuple(schedule))]

    results: list[RunResult] = []
    seen: set = {()}
    stack: list[tuple] = [()]
    while stack and len(results) < max_runs:
        prefix = stack.pop()
        res = run_schedule(scenario, prefix)
        results.append(res)
        decs = res.decisions
        for pos in range(len(prefix), len(decs)):
            d = decs[pos]
            base = _preemptions(decs, pos)
            for alt in range(d["n"]):
                if alt == d["choice"]:
                    continue
                extra = 1 if (d["last_pos"] is not None and alt != d["last_pos"]) else 0
                if base + extra > bound:
                    continue
                cand = tuple(x["choice"] for x in decs[:pos]) + (alt,)
                if cand not in seen:
                    seen.add(cand)
                    stack.append(cand)
    return results
