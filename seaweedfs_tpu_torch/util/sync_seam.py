"""Shared instrumentation seam over Python's synchronization primitives:
the port of seaweedfs_tpu/util/sync_seam.py.

One install point patches ``threading.Lock``/``RLock``/``Event``,
``threading.Thread.start``/``join`` and ``queue.Queue.put``/``get`` with
instrumented variants.  Checkers register *listeners* and receive a stream
of synchronization events; the seam itself keeps no analysis state beyond
the per-thread held-lock stack both checkers need:

* :mod:`seaweedfs_tpu_torch.util.lockcheck` consumes ``lock_acquired`` /
  ``lock_released`` to build the lock-order graph and hold-duration
  records.
* :mod:`seaweedfs_tpu_torch.util.racecheck` consumes every event to
  maintain per-thread vector clocks and release/acquire happens-before
  edges.

Both compose: ``install()`` is reference-counted per component, so both
checkers on at once patch the primitives exactly once and dispatch to both
listeners.  The pytest plugin :mod:`seaweedfs_tpu_torch.util.checkers_pytest`
is the switch that installs them for a test run.

The real primitives come from ``_thread`` (``allocate_lock``, ``RLock``)
and from ``threading``/``queue`` as long as those are unpatched.  One
process may hold a second seam (the JAX package's has the same design):
:func:`install` refuses, with RuntimeError, while anything else has
patched ``threading`` or ``queue``, so this seam never wraps another
seam's wrappers and never restores them as if they were the real ones.

The seam also carries the cooperative-scheduler *gate* used by the
``weedrace`` interleaving explorer (:mod:`seaweedfs_tpu_torch.weedrace.sched`):
when a gate is set, instrumented threads route blocking operations (lock
acquire, queue put/get, ``Event.wait``, ``Thread.join``) through the gate
so a deterministic scheduler can serialize them onto one runnable-at-a-time
token.  With no gate set (the normal case) every operation goes straight
to the real primitive.

Event vocabulary (all optional on a listener, dispatched by name):

``lock_acquired(lock, site, held_sites, record_edges, reentry)``
    after the inner lock is taken; ``held_sites`` is the set of
    allocation sites already held by this thread, ``record_edges`` is
    False for non-blocking (try) acquires, ``reentry`` True when this
    thread already held this lock (RLock).
``lock_released(lock, site, held_for, reentry)``
    just before the inner lock is released; ``held_for`` is seconds held.
``lock_wait_release(lock)`` / ``lock_wait_reacquire(lock)``
    ``Condition.wait`` dropping / re-taking the wrapped lock via the
    ``_release_save``/``_acquire_restore`` protocol.
``thread_start(parent, thread)``
    in the parent, before the OS thread starts.
``thread_run_begin(thread)`` / ``thread_run_end(thread)``
    first/last thing on the child thread.
``thread_joined(caller, thread)``
    after a successful (thread actually dead) ``join``.
``queue_put(queue)`` / ``queue_get(queue)``
    before an item is enqueued / after one is dequeued.
``event_set(event)`` / ``event_wait_return(event)``
    before ``Event.set`` flips the flag / after ``Event.wait`` returns
    True.
"""

from __future__ import annotations

import _thread
import os
import queue as _queue_mod
import sys
import threading
import time

# The real lock types come straight from _thread, so they are real whatever
# patched threading before this module was imported.
REAL_LOCK = _thread.allocate_lock
REAL_RLOCK = _thread.RLock


def _real_event_class() -> type:
    """threading's own Event, even under a subclass another seam installed."""
    return next(c for c in threading.Event.__mro__
                if c.__module__ == "threading" and c.__name__ == "Event")


REAL_EVENT = _real_event_class()


def foreign_patches() -> list[str]:
    """The primitives that something other than this seam has replaced:
    empty when ``threading`` and ``queue`` hold their own definitions or
    this seam's."""
    ours = {InstrumentedLock, InstrumentedRLock, InstrumentedEvent,
            _patched_thread_start, _patched_thread_join, _patched_queue_put,
            _patched_queue_get}
    current = {
        "threading.Lock": (threading.Lock, None),
        "threading.RLock": (threading.RLock, "threading"),
        "threading.Event": (threading.Event, "threading"),
        "threading.Thread.start": (threading.Thread.start, "threading"),
        "threading.Thread.join": (threading.Thread.join, "threading"),
        "queue.Queue.put": (_queue_mod.Queue.put, "queue"),
        "queue.Queue.get": (_queue_mod.Queue.get, "queue"),
    }
    bad = []
    for name, (val, home) in current.items():
        if val in ours:
            continue
        genuine = (val is _thread.allocate_lock if home is None
                   else getattr(val, "__module__", None) == home)
        if not genuine:
            bad.append(name)
    return bad


# threading's RLock factory, Thread.start/join and Queue.put/get as found at
# import; install() takes them again (and checks them) when it patches, and
# uninstall puts back what install took.
_REAL_RLOCK_FACTORY = threading.RLock
_REAL_THREAD_START = threading.Thread.start
_REAL_THREAD_JOIN = threading.Thread.join
_REAL_QUEUE_PUT = _queue_mod.Queue.put
_REAL_QUEUE_GET = _queue_mod.Queue.get

_listeners: list = []  # dispatch order = registration order
_components: set[str] = set()  # refcounted install()
_tls = threading.local()

# Files skipped when resolving a lock's allocation site.
_SKIP_FILES = {__file__}


def add_listener(listener) -> None:
    if listener not in _listeners:
        _listeners.append(listener)


def remove_listener(listener) -> None:
    if listener in _listeners:
        _listeners.remove(listener)


def current_thread_or_none():
    """The current Thread, or None when the thread is not (yet) registered.

    ``threading.current_thread()`` materializes a ``_DummyThread`` for
    unregistered threads — and ``_DummyThread.__init__`` touches a fresh
    (instrumented) Event *before* registering, so calling it from seam
    callbacks recurses forever.  Notably a thread's own bootstrap sets
    ``_started`` before registering itself, so every instrumented thread
    passes through this window once.
    """
    return threading._active.get(threading.get_ident())


def _emit(name: str, *args) -> None:
    # reentrancy guard: a listener touching an instrumented primitive
    # (or bootstrap-window code creating one) must not re-enter dispatch
    if getattr(_tls, "emitting", False):
        return
    _tls.emitting = True
    try:
        for listener in _listeners:
            fn = getattr(listener, name, None)
            if fn is not None:
                fn(*args)
    finally:
        _tls.emitting = False


# -- cooperative scheduler gate (weedrace explorer) -------------------------

_gate = None


def set_gate(gate) -> None:
    """Install (or clear, with None) the explorer's scheduler gate."""
    global _gate
    _gate = gate


def _gate_for_current():
    g = _gate
    if g is None:
        return None
    t = current_thread_or_none()
    if t is not None and g.controls(t):
        return g
    return None


# -- per-thread held-lock stack ---------------------------------------------


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def held_sites() -> list[str]:
    """Allocation sites of locks the current thread holds, outermost first."""
    return [entry[1] for entry in _stack()]


def _alloc_site() -> str:
    """file:line of the lock's construction, skipping seam internals."""
    f = sys._getframe(2)  # noqa: SLF001
    while f is not None and f.f_code.co_filename in _SKIP_FILES:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter internals
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


# -- lock wrappers ----------------------------------------------------------


class _InstrumentedBase:
    """Shared acquire/release bookkeeping for Lock and RLock wrappers."""

    _reentrant = False

    def __init__(self):
        self._site = _alloc_site()
        self._inner = (REAL_RLOCK if self._reentrant else REAL_LOCK)()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        gate = _gate_for_current()
        if gate is not None:
            got = gate.lock_acquire(self, blocking, timeout)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            self._on_acquired(record_edges=blocking)
        return got

    def release(self):
        self._on_release()
        self._inner.release()
        gate = _gate_for_current()
        if gate is not None:
            gate.lock_released(self)

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # os.fork handlers (concurrent.futures, logging) reset their locks
        self._inner._at_fork_reinit()

    def __repr__(self):
        return f"<{type(self).__name__} {self._site}>"

    # -- Condition protocol (threading.Condition wraps arbitrary locks) ----
    def _release_save(self):
        # drop our bookkeeping entirely: the condition wait releases the lock
        saved = []
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self:
                saved.append(st.pop(i))
        _emit("lock_wait_release", self)
        inner_state = self._inner._release_save() if hasattr(
            self._inner, "_release_save"
        ) else (self._inner.release() or None)
        gate = _gate_for_current()
        if gate is not None:
            gate.lock_released(self)
        return (inner_state, saved)

    def _acquire_restore(self, state):
        inner_state, saved = state
        gate = _gate_for_current()
        if gate is not None:
            gate.lock_wait_reacquire(self, inner_state)
        elif hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        # a hold restarts at the reacquire: the wait released the lock, so
        # its time is no hold (held-too-long must not count a long wait)
        now = time.monotonic()
        _stack().extend((lock, site, now, reentry)
                        for lock, site, _t0, reentry in reversed(saved))
        _emit("lock_wait_reacquire", self)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock heuristic (mirrors threading.Condition's fallback)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    # -- bookkeeping -------------------------------------------------------
    def _on_acquired(self, record_edges: bool = True):
        st = _stack()
        already_held = any(entry[0] is self for entry in st)
        held = {entry[1] for entry in st}
        _emit("lock_acquired", self, self._site, held, record_edges,
              already_held)
        st.append((self, self._site, time.monotonic(), already_held))

    def _on_release(self):
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self:
                _, site, t0, reentry = st.pop(i)
                held_for = time.monotonic() - t0
                _emit("lock_released", self, site, held_for, reentry)
                return
        # release without matching acquire (handed across threads): ignore


class InstrumentedLock(_InstrumentedBase):
    _reentrant = False


class InstrumentedRLock(_InstrumentedBase):
    _reentrant = True

    def _recursion_count(self):
        # read by multiprocessing's resource tracker (3.12) on its RLock
        return self._inner._recursion_count()


_RAW_LOCK_TYPE = type(REAL_LOCK())
_RAW_RLOCK_TYPE = REAL_RLOCK


def rearm_module_locks(owner) -> int:
    """Swap the raw ``Lock``/``RLock`` attributes of ``owner`` (a module,
    or any object with a ``__dict__``) for instrumented ones; returns how
    many were swapped.

    Locks created before :func:`install` bypass the seam entirely — no
    events, no happens-before edges, no held-lock evidence — so a
    correctly locked module imported early reads as racy.  Harnesses that
    drive module-level protocol state (the weedrace scenarios, the card
    step of chip_smoke.py) call this from single-threaded setup, when no
    lock can be held; swapping a held lock would orphan its owner's
    release.
    """
    name_of = getattr(owner, "__name__", type(owner).__name__)
    swapped = 0
    for name, val in list(vars(owner).items()):
        if isinstance(val, _InstrumentedBase):
            continue
        if type(val) is _RAW_LOCK_TYPE:
            if val.locked():
                raise RuntimeError(f"rearm_module_locks: {name_of}.{name} is held")
            setattr(owner, name, InstrumentedLock())
            swapped += 1
        elif type(val) is _RAW_RLOCK_TYPE:
            if repr(val).startswith("<locked"):
                raise RuntimeError(f"rearm_module_locks: {name_of}.{name} is held")
            setattr(owner, name, InstrumentedRLock())
            swapped += 1
    return swapped


class InstrumentedEvent(REAL_EVENT):
    def set(self):
        _emit("event_set", self)
        super().set()

    def wait(self, timeout=None):
        gate = _gate_for_current()
        if gate is not None:
            got = gate.event_wait(self, timeout)
        else:
            got = super().wait(timeout)
        if got:
            _emit("event_wait_return", self)
        return got


# -- thread / queue patches -------------------------------------------------


def _patched_thread_start(self):
    _emit("thread_start", current_thread_or_none(), self)
    if not getattr(self, "_seam_run_wrapped", False):
        self._seam_run_wrapped = True
        real_run = self.run

        def _seam_run():
            _emit("thread_run_begin", self)
            try:
                real_run()
            finally:
                _emit("thread_run_end", self)

        self.run = _seam_run
    _REAL_THREAD_START(self)


def _patched_thread_join(self, timeout=None):
    gate = _gate_for_current()
    if gate is not None:
        gate.join_thread(self, timeout)
    else:
        _REAL_THREAD_JOIN(self, timeout)
    if not self.is_alive():
        _emit("thread_joined", current_thread_or_none(), self)


def _patched_queue_put(self, item, block=True, timeout=None):
    # publish BEFORE the item becomes visible: a getter that pops the item
    # immediately must already find the putter's clock snapshot
    _emit("queue_put", self)
    gate = _gate_for_current()
    if gate is not None:
        return gate.queue_put(self, item, block, timeout)
    return _REAL_QUEUE_PUT(self, item, block, timeout)


def _patched_queue_get(self, block=True, timeout=None):
    gate = _gate_for_current()
    if gate is not None:
        item = gate.queue_get(self, block, timeout)
    else:
        item = _REAL_QUEUE_GET(self, block, timeout)
    _emit("queue_get", self)
    return item


def real_thread_join(thread, timeout=None) -> None:
    """``Thread.join`` past the seam (no gate, no event)."""
    _REAL_THREAD_JOIN(thread, timeout)


def real_queue_put(q, item, block=True, timeout=None):
    return _REAL_QUEUE_PUT(q, item, block, timeout)


def real_queue_get(q, block=True, timeout=None):
    return _REAL_QUEUE_GET(q, block, timeout)


# -- installation -----------------------------------------------------------


def installed() -> bool:
    return bool(_components)


def install(component: str) -> None:
    """Patch the primitives (idempotent, refcounted per component).

    Raises RuntimeError, and patches nothing, while another seam has
    patched ``threading`` or ``queue``."""
    global _REAL_THREAD_START, _REAL_THREAD_JOIN, _REAL_QUEUE_PUT, _REAL_QUEUE_GET
    global _REAL_RLOCK_FACTORY
    if not _components:
        foreign = foreign_patches()
        if foreign:
            raise RuntimeError(
                "sync_seam: another instrumentation seam has patched "
                f"{', '.join(foreign)}; uninstall it first (two seams in one "
                "process must not wrap each other)"
            )
        _REAL_RLOCK_FACTORY = threading.RLock
        _REAL_THREAD_START = threading.Thread.start
        _REAL_THREAD_JOIN = threading.Thread.join
        _REAL_QUEUE_PUT = _queue_mod.Queue.put
        _REAL_QUEUE_GET = _queue_mod.Queue.get
        threading.Lock = InstrumentedLock  # type: ignore[misc, assignment]
        threading.RLock = InstrumentedRLock  # type: ignore[misc, assignment]
        threading.Event = InstrumentedEvent  # type: ignore[misc, assignment]
        threading.Thread.start = _patched_thread_start  # type: ignore[method-assign]
        threading.Thread.join = _patched_thread_join  # type: ignore[method-assign]
        _queue_mod.Queue.put = _patched_queue_put  # type: ignore[method-assign]
        _queue_mod.Queue.get = _patched_queue_get  # type: ignore[method-assign]
    _components.add(component)


def uninstall(component: str) -> None:
    if component not in _components:
        return
    _components.discard(component)
    if not _components:
        threading.Lock = REAL_LOCK  # type: ignore[misc]
        threading.RLock = _REAL_RLOCK_FACTORY  # type: ignore[misc]
        threading.Event = REAL_EVENT  # type: ignore[misc]
        threading.Thread.start = _REAL_THREAD_START  # type: ignore[method-assign]
        threading.Thread.join = _REAL_THREAD_JOIN  # type: ignore[method-assign]
        _queue_mod.Queue.put = _REAL_QUEUE_PUT  # type: ignore[method-assign]
        _queue_mod.Queue.get = _REAL_QUEUE_GET  # type: ignore[method-assign]

