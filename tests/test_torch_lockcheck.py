"""The port's util.lockcheck (seaweedfs_tpu_torch): lock-order cycle
detection, held-too-long tracking, and threading.Condition protocol
compatibility of the wrappers — a counterpart of every case of
tests/test_lockcheck.py, run on the port's seam — and the port's seam
against the JAX package's in one process."""

from __future__ import annotations

import threading
import time

import pytest

from seaweedfs_tpu_torch.util import lockcheck, sync_seam
from torch_seam_helpers import no_jax_seam  # noqa: E402,F401 (autouse)


@pytest.fixture(autouse=True)
def _clean_state():
    """Run each test against empty analysis state, then RESTORE the
    session-wide state: under the checkers plugin's --weed-lockcheck, the
    port's instrumentation is installed for the whole session — this module must
    neither erase the edges other suites collected nor leave its own
    deliberate AB-BA cycles (or de-instrumented locks) behind."""
    was_installed = lockcheck._installed
    with lockcheck._state_mu:
        saved_edges = {k: set(v) for k, v in lockcheck._edges.items()}
        saved_threads = dict(lockcheck._edge_threads)
        saved_held = list(lockcheck._held_too_long)
    lockcheck.reset()
    yield
    with lockcheck._state_mu:
        lockcheck._edges.clear()
        lockcheck._edges.update(saved_edges)
        lockcheck._edge_threads.clear()
        lockcheck._edge_threads.update(saved_threads)
        del lockcheck._held_too_long[:]
        lockcheck._held_too_long.extend(saved_held)
    if was_installed:
        lockcheck.install()
    else:
        lockcheck.uninstall()


def test_ab_ba_cycle_detected():
    """The canonical deadlock: thread 1 takes A then B, thread 2 takes B
    then A.  Serialized here so the run never actually deadlocks — the
    graph still exposes the inversion."""
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = lockcheck.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {a._site, b._site}


def test_consistent_order_no_cycle():
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.cycles() == []
    # the one edge a->b was recorded
    assert lockcheck.report()["edges"] == {a._site: [b._site]}


def test_three_lock_rotation_cycle():
    # one lock per line: lock classes are allocation sites
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()
    c = lockcheck.CheckedLock()
    for first, second in ((a, b), (b, c), (c, a)):
        with first:
            with second:
                pass
    cycles = lockcheck.cycles()
    assert len(cycles) == 1
    assert set(cycles[0]) == {a._site, b._site, c._site}


def test_rlock_reentry_is_not_an_edge():
    r = lockcheck.CheckedRLock()
    with r:
        with r:  # reentrant: must not create a self-edge or any edge
            pass
    assert lockcheck.report()["edges"] == {}
    assert lockcheck.cycles() == []


def test_cross_thread_edges_merge():
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    th1 = threading.Thread(target=t1)
    th1.start()
    th1.join()
    th2 = threading.Thread(target=t2)
    th2.start()
    th2.join()
    assert len(lockcheck.cycles()) == 1


def test_held_too_long_recorded(monkeypatch):
    monkeypatch.setattr(lockcheck, "HOLD_THRESHOLD", 0.01)
    lk = lockcheck.CheckedLock()
    with lk:
        time.sleep(0.05)
    rep = lockcheck.report()
    assert rep["held_too_long"], rep
    assert rep["held_too_long"][0]["site"] == lk._site
    assert rep["held_too_long"][0]["seconds"] >= 0.01


def test_condition_protocol_with_wrapped_rlock():
    lk = lockcheck.CheckedRLock()
    cond = threading.Condition(lk)
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=2)
            hits.append("woke")

    th = threading.Thread(target=waiter)
    th.start()
    time.sleep(0.05)
    with cond:
        hits.append("signal")
        cond.notify_all()
    th.join(timeout=3)
    assert not th.is_alive()
    assert "woke" in hits


def test_trylock_success_records_no_edge():
    """A non-blocking acquire never waits, so it cannot deadlock: like
    lockdep, it must not contribute wait-for edges (a trylock inversion
    against a blocking path is not a cycle)."""
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()
    with a:
        assert b.acquire(blocking=False) is True
        b.release()
    with b:
        with a:  # would be a cycle if the trylock had recorded b under a
            pass
    assert lockcheck.cycles() == []
    assert lockcheck.report()["edges"] == {b._site: [a._site]}


def test_nonblocking_acquire_failure_records_nothing():
    a = lockcheck.CheckedLock()
    b = lockcheck.CheckedLock()
    b._inner.acquire()  # make b contended without bookkeeping
    try:
        with a:
            assert b.acquire(blocking=False) is False
    finally:
        b._inner.release()
    assert lockcheck.report()["edges"] == {}


def test_install_patches_threading():
    lockcheck.install()
    try:
        assert threading.Lock is lockcheck.CheckedLock
        assert threading.RLock is lockcheck.CheckedRLock
        lk = threading.Lock()
        assert isinstance(lk, lockcheck.CheckedLock)
        with lk:
            assert lk.locked()
        assert not lk.locked()
    finally:
        lockcheck.uninstall()
    assert threading.Lock is lockcheck._REAL_LOCK


def test_installed_queue_still_works():
    """queue.Queue wires Conditions over the patched locks — the protocol
    shims must keep it fully functional."""
    import queue

    lockcheck.install()
    try:
        q = queue.Queue()
        results = []

        def consumer():
            results.append(q.get(timeout=3))

        th = threading.Thread(target=consumer)
        th.start()
        q.put("item")
        th.join(timeout=3)
        assert results == ["item"]
    finally:
        lockcheck.uninstall()


def test_installed_condition_wait_regression():
    """Condition.wait under the PATCHED locks (install() active): wait's
    _release_save/_acquire_restore/_is_owned protocol must round-trip
    through CheckedLock/CheckedRLock without deadlock, without a spurious
    lock-order cycle, and without leaking a held-lock record across the
    wait (the wait releases the lock — a report claiming it stayed held
    would poison every edge recorded while a waiter slept)."""
    lockcheck.install()
    try:
        for factory in (threading.Lock, threading.RLock, None):
            cond = threading.Condition(factory() if factory else None)
            ready = []
            woke = []

            def waiter(c=cond, r=ready, w=woke):
                with c:
                    r.append(True)
                    if c.wait(timeout=5):
                        w.append(True)

            th = threading.Thread(target=waiter)
            th.start()
            deadline = time.monotonic() + 3
            while not ready and time.monotonic() < deadline:
                time.sleep(0.01)
            # while the waiter sleeps inside wait(), the lock is RELEASED:
            # another thread must be able to take it immediately
            with cond:
                cond.notify_all()
            th.join(timeout=5)
            assert not th.is_alive()
            assert woke == [True]
        rep = lockcheck.report()
        assert not rep["cycles"], rep
    finally:
        lockcheck.uninstall()


# -- the port's seam beside the JAX package's --------------------------------

from seaweedfs_tpu.util import lockcheck as jax_lockcheck  # noqa: E402


@pytest.fixture
def _jax_state():
    """Keep the JAX package's session-wide lockcheck state as it was."""
    was_installed = jax_lockcheck._installed
    jax_lockcheck.uninstall()  # its seam is already off (no_jax_seam)
    with jax_lockcheck._state_mu:
        saved = ({k: set(v) for k, v in jax_lockcheck._edges.items()},
                 dict(jax_lockcheck._edge_threads), list(jax_lockcheck._held_too_long))
    jax_lockcheck.reset()
    yield
    with jax_lockcheck._state_mu:
        jax_lockcheck._edges.clear()
        jax_lockcheck._edges.update(saved[0])
        jax_lockcheck._edge_threads.clear()
        jax_lockcheck._edge_threads.update(saved[1])
        del jax_lockcheck._held_too_long[:]
        jax_lockcheck._held_too_long.extend(saved[2])
    if was_installed:
        jax_lockcheck.install()
    else:
        jax_lockcheck.uninstall()


def test_port_seam_refuses_to_install_over_the_jax_seam(_jax_state):
    assert not lockcheck._installed
    jax_lockcheck.install()
    try:
        jax_lock = threading.Lock
        assert sync_seam.foreign_patches(), "the JAX seam's patches went unseen"
        with pytest.raises(RuntimeError, match="another instrumentation seam"):
            lockcheck.install()
        assert not lockcheck._installed and not sync_seam.installed()
        assert threading.Lock is jax_lock  # the JAX wrappers were not wrapped
    finally:
        jax_lockcheck.uninstall()
    assert sync_seam.foreign_patches() == []
    lockcheck.install()
    try:
        assert threading.Lock is lockcheck.CheckedLock
    finally:
        lockcheck.uninstall()


def test_uninstall_restores_the_real_primitives():
    import queue

    before = (threading.Lock, threading.RLock, threading.Event, threading.Thread.start,
              threading.Thread.join, queue.Queue.put, queue.Queue.get)
    lockcheck.install()
    assert threading.RLock is lockcheck.CheckedRLock
    assert threading.Event is sync_seam.InstrumentedEvent
    lockcheck.uninstall()
    after = (threading.Lock, threading.RLock, threading.Event, threading.Thread.start,
             threading.Thread.join, queue.Queue.put, queue.Queue.get)
    assert after == before
    assert sync_seam.foreign_patches() == []


def _ab_ba(mod):
    """One AB-BA inversion with mod's checked locks (same lines for both
    packages, so both name the same allocation sites)."""
    a = mod.CheckedLock()
    b = mod.CheckedLock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return a, b


def test_port_and_jax_lockcheck_report_the_same_cycle(_jax_state):
    a, b = _ab_ba(lockcheck)
    ja, jb = _ab_ba(jax_lockcheck)
    assert (a._site, b._site) == (ja._site, jb._site)
    assert lockcheck.cycles() == jax_lockcheck.cycles() == [sorted([a._site, b._site])]
    assert lockcheck.report()["edges"] == jax_lockcheck.report()["edges"]


def test_a_condition_wait_is_no_hold(_jax_state, monkeypatch):
    """Condition.wait releases the lock, so its time is no hold: the port's
    seam restarts a hold at the reacquire, and a 0.3 s wait under a 0.1 s
    threshold records nothing, where the JAX seam keeps the hold's start
    from before the wait and records it (ROADMAP Queue C item 24)."""
    recorded = {}
    for name, mod in (("port", lockcheck), ("jax", jax_lockcheck)):
        monkeypatch.setattr(mod, "HOLD_THRESHOLD", 0.1)
        cond = threading.Condition(mod.CheckedLock())
        with cond:
            cond.wait(timeout=0.3)
        recorded[name] = [h["site"] for h in mod.report()["held_too_long"]]
    assert recorded["port"] == []
    assert len(recorded["jax"]) == 1, "the JAX seam no longer counts the wait: update item 24"


def test_the_instrumented_rlock_answers_like_the_real_one():
    """Every method of the real RLock that the standard library calls
    (multiprocessing's resource tracker reads ``_recursion_count`` when
    it stops) answers through the wrapper; the JAX seam's wrapper lacks
    ``_recursion_count`` (ROADMAP Queue C item 25)."""
    import _thread

    real = [m for m in dir(_thread.RLock) if not m.startswith("__")]
    r = lockcheck.CheckedRLock()
    assert [m for m in real if not hasattr(r, m)] == []
    assert [m for m in real if not hasattr(jax_lockcheck.CheckedRLock, m)] == ["_recursion_count"]
    with r:
        with r:
            assert r._recursion_count() == 2 and r._is_owned()
    assert r._recursion_count() == 0
