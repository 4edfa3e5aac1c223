"""The port's racecheck (seaweedfs_tpu_torch): vector-clock happens-before
detection + the port's weedrace explorer.

A counterpart of every case of tests/test_racecheck.py, on the port's
seam: every fixture race is DETECTED and every clean twin stays SILENT
(edges flow through locks, queues, events, and fork/join); the
suppression grammar (justified vs bare), schedule replay determinism, the
WEED_RACECHECK_SCHEDULE env override, SARIF shape, and the chunk-cache
hit_rate regression, whose justified suppressions the port's detector
exercises.  Then the port against the JAX package: the same races on every
fixture, the same schedules from the same explore call, and the two faults
of the JAX detector that the port repairs (ROADMAP Queue C items 22, 23):
writes in Python 3.12 bytecode it cannot read, and races between two
objects that shared a recycled id().
"""

from __future__ import annotations

import importlib.util
import os
import queue
import sys
import threading

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from seaweedfs_tpu_torch.util import racecheck, sync_seam  # noqa: E402
from torch_seam_helpers import no_jax_seam  # noqa: E402,F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "weedrace")


@pytest.fixture
def rc(monkeypatch):
    monkeypatch.delenv("WEED_RACECHECK_MODULES", raising=False)
    monkeypatch.delenv("WEED_RACECHECK_SCHEDULE", raising=False)
    racecheck.install()
    racecheck.reset()
    yield racecheck
    racecheck.reset()
    racecheck.uninstall()


def _run_fixture(name: str):
    path = os.path.join(FIXTURES, name + ".py")
    racecheck.add_scope_file(path)
    spec = importlib.util.spec_from_file_location(f"weedrace_fx_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run()


# -- fixtures: fire on the race, stay silent on the twins -------------------


def test_racy_pair_detected(rc):
    _run_fixture("racy_pair")
    report = rc.report()
    races = [r for r in report["races"] if r["attr"] == "value"]
    assert races, f"racy fixture not detected: {report}"
    r = races[0]
    assert r["object"] == "Shared"
    assert "racy_pair.py" in r["a"]["site"][0]
    assert "racy_pair.py" in r["b"]["site"][0]
    # both sides carry their stack and (empty) lock set
    assert r["a"]["locks"] == ()
    assert r["b"]["locks"] == ()
    assert r["a"]["stack"] and r["b"]["stack"]


def test_locked_twin_silent(rc):
    obj = _run_fixture("locked_twin")
    assert obj.value == 2
    assert rc.report()["races"] == []


def test_queue_twin_silent(rc):
    seen = _run_fixture("queue_twin")
    assert seen == [42]
    assert rc.report()["races"] == []


def test_event_handoff_silent(rc):
    class Box:
        def __init__(self):
            self.value = 0

    box = Box()
    ev = threading.Event()
    got = []

    def writer():
        box.value = 7
        ev.set()

    def reader():
        ev.wait()
        got.append(box.value)

    here = os.path.abspath(__file__)
    rc.add_scope_file(here)
    t1 = threading.Thread(target=writer)
    t2 = threading.Thread(target=reader)
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    assert got == [7]
    races = [r for r in rc.report()["races"] if r["object"] == "Box"]
    assert races == []


def test_benign_suppressed(rc):
    _run_fixture("benign_suppressed")
    report = rc.report()
    assert [r for r in report["races"] if r["attr"] == "peeks"] == []
    assert any(r["attr"] == "peeks" for r in report["suppressed"])
    assert report["bare_directives"] == 0


def test_bare_directive_does_not_suppress(rc):
    _run_fixture("bare_directive")
    report = rc.report()
    assert any(r["attr"] == "peeks" for r in report["races"])
    assert report["bare_directives"] >= 1


# -- vector-clock edges -----------------------------------------------------


def test_fork_join_edges(rc):
    parent_at_spawn = rc.current_clock()
    child_clock = {}

    def child():
        child_clock.update(rc.current_clock())

    t = threading.Thread(target=child)
    t.start()
    t.join()
    for tid, clk in parent_at_spawn.items():
        assert child_clock.get(tid, 0) >= clk, (parent_at_spawn, child_clock)
    parent_after_join = rc.current_clock()
    for tid, clk in child_clock.items():
        assert parent_after_join.get(tid, 0) >= clk


def test_lock_release_acquire_edge(rc):
    lk = threading.Lock()
    a_clock = {}
    order_gate = threading.Event()

    def a():
        with lk:
            a_clock.update(rc.current_clock())
        order_gate.set()

    b_clock = {}

    def b():
        order_gate.wait()
        with lk:
            b_clock.update(rc.current_clock())

    t1 = threading.Thread(target=a)
    t2 = threading.Thread(target=b)
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    # b acquired after a released: a's clock flowed through the lock
    for tid, clk in a_clock.items():
        assert b_clock.get(tid, 0) >= clk, (a_clock, b_clock)


def test_queue_handoff_edge(rc):
    q = queue.Queue()
    put_clock = {}
    get_clock = {}

    def producer():
        put_clock.update(rc.current_clock())
        q.put(1)

    def consumer():
        q.get()
        get_clock.update(rc.current_clock())

    t1 = threading.Thread(target=producer)
    t2 = threading.Thread(target=consumer)
    t1.start()
    t2.start()
    t1.join()
    t2.join()
    for tid, clk in put_clock.items():
        assert get_clock.get(tid, 0) >= clk, (put_clock, get_clock)


# -- explorer: determinism + env replay -------------------------------------


def _two_step_scenario(gate):
    out = []
    lk = threading.Lock()

    def a():
        with lk:
            out.append("a")
        with lk:
            out.append("a2")

    def b():
        with lk:
            out.append("b")

    gate.spawn(a, "a")
    gate.spawn(b, "b")
    return None


def test_explore_covers_multiple_schedules(rc):
    from seaweedfs_tpu_torch.weedrace.sched import explore

    results = explore(_two_step_scenario, bound=2, max_runs=16)
    assert len(results) > 1
    assert len({r.schedule_used for r in results}) == len(results)
    assert all(not r.deadlock and not r.errors for r in results)


def test_schedule_replay_is_deterministic(rc):
    from seaweedfs_tpu_torch.weedrace.sched import explore, run_schedule

    results = explore(_two_step_scenario, bound=2, max_runs=16)
    target = results[-1]
    r1 = run_schedule(_two_step_scenario, target.schedule_used)
    r2 = run_schedule(_two_step_scenario, target.schedule_used)
    assert r1.schedule_used == r2.schedule_used == target.schedule_used


def test_env_schedule_short_circuits(rc, monkeypatch):
    from seaweedfs_tpu_torch.weedrace.sched import explore

    results = explore(_two_step_scenario, bound=2, max_runs=16)
    pick = next(r for r in results if len(r.schedule_used) >= 2)
    monkeypatch.setenv(
        "WEED_RACECHECK_SCHEDULE",
        ",".join(str(c) for c in pick.schedule_used),
    )
    replayed = explore(_two_step_scenario, bound=2, max_runs=16)
    assert len(replayed) == 1
    assert replayed[0].schedule_used == pick.schedule_used


def test_explorer_exposes_and_replays_lost_update(rc, monkeypatch):
    """The canonical read-modify-write bug: only SOME schedules lose an
    update.  The explorer must find one, and the losing schedule must
    replay deterministically from WEED_RACECHECK_SCHEDULE."""
    from seaweedfs_tpu_torch.weedrace.sched import explore

    def scenario(gate):
        state = {"obj": None}

        class Counter:
            def __init__(self):
                self.n = 0

        state["obj"] = Counter()
        q = queue.Queue()
        q.put(None)  # pre-charged: put/get below never block

        def bump():
            tmp = state["obj"].n
            # a scheduling point between read and write: the explorer
            # can preempt here, making the lost update reachable
            q.get()
            q.put(None)
            state["obj"].n = tmp + 1

        gate.spawn(bump, "bump-a")
        gate.spawn(bump, "bump-b")

        def check():
            assert state["obj"].n == 2, f"lost update: n={state['obj'].n}"

        return check

    results = explore(scenario, bound=2, max_runs=32)
    losing = [r for r in results if r.errors]
    assert losing, "explorer never exposed the lost update"
    bad = losing[0]
    monkeypatch.setenv(
        "WEED_RACECHECK_SCHEDULE",
        ",".join(str(c) for c in bad.schedule_used),
    )
    replay = explore(scenario, bound=2, max_runs=32)
    assert len(replay) == 1
    assert replay[0].schedule_used == bad.schedule_used
    assert replay[0].errors, "seeded schedule did not reproduce the failure"


def test_deadlock_detected(rc):
    from seaweedfs_tpu_torch.weedrace.sched import run_schedule

    def scenario(gate):
        lk1 = threading.Lock()
        lk2 = threading.Lock()

        def ab():
            with lk1:
                with lk2:
                    pass

        def ba():
            with lk2:
                with lk1:
                    pass

        gate.spawn(ab, "ab")
        gate.spawn(ba, "ba")
        return None

    # schedule the classic interleave: a takes lk1, then b runs to lk1
    found = False
    for schedule in ([1], [0, 1], [0, 0, 1], [1, 1], [1, 0]):
        res = run_schedule(scenario, schedule)
        if res.deadlock:
            found = True
            break
    assert found, "AB-BA interleaving never deadlocked under the explorer"


# -- SARIF shape ------------------------------------------------------------


def test_sarif_shape(rc):
    _run_fixture("racy_pair")
    report = rc.report()
    assert report["races"]
    from seaweedfs_tpu_torch.weedrace import race_violation
    from seaweedfs_tpu_torch.weedrace.sarif import to_sarif

    doc = to_sarif([race_violation(r) for r in report["races"]])
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "weedrace"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"R001", "R002", "R003", "R004"} <= rule_ids
    res = run["results"][0]
    assert res["ruleId"] == "R001"
    loc = res["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"].endswith("racy_pair.py")
    assert loc["region"]["startLine"] >= 1


# -- burn-down pins ---------------------------------------------------------


def test_hit_rate_stays_bounded_and_suppressed(rc, tmp_path):
    """hit_rate() snapshots its counters once (no >1.0 ratios under
    concurrent lookups), and the remaining benign counter races (the
    ``+=`` bumps in lookup against hit_rate's reads) carry justified
    suppressions, which the port's detector reaches."""
    from seaweedfs_tpu_torch.weedrace.sched import explore

    def scenario(gate):
        from seaweedfs_tpu_torch.util.chunk_cache import ChunkCache

        cache = ChunkCache(
            1 << 20, ram_bytes=8 << 10, directory=str(tmp_path),
            small_max=256, max_chunk=8 << 10,
        )
        cache.fill("7,aa", 0, 100, lambda: b"x" * 100)
        rates = []

        def reader():
            rates.append(cache.hit_rate())

        def toucher():
            cache.lookup("7,aa", 0, 100)
            cache.lookup("7,miss", 0, 100)

        gate.spawn(reader, "rate")
        gate.spawn(toucher, "touch")

        def check():
            assert all(0.0 <= r <= 1.0 for r in rates), rates

        return check

    results = explore(scenario, bound=1, max_runs=8)
    assert all(not r.errors for r in results), [r.errors for r in results]
    report = rc.report()
    cc = [r for r in report["races"]
          if r["object"] == "ChunkCache" and r["attr"] in ("hits", "misses")]
    assert cc == [], f"hit_rate counter races must be suppressed: {cc}"
    assert any(
        r["object"] == "ChunkCache" for r in report["suppressed"]
    ), "expected the justified hit_rate suppressions to be exercised"


# -- composability ----------------------------------------------------------


def test_composes_with_lockcheck(rc):
    from seaweedfs_tpu_torch.util import lockcheck

    lockcheck.install()
    try:
        assert sync_seam.installed()
        assert threading.Lock is sync_seam.InstrumentedLock
        _run_fixture("racy_pair")
        assert rc.report()["races"]  # racecheck still live under both
    finally:
        lockcheck.uninstall()
    # racecheck still holds the seam after lockcheck leaves
    assert threading.Lock is sync_seam.InstrumentedLock


def test_rearm_module_locks_swaps_preinstall_locks(rc):
    # a module imported before install() carries raw locks the seam never
    # sees — rearm swaps them (single-threaded) so edges exist; already
    # instrumented locks and held raw locks are handled explicitly
    import types

    mod = types.ModuleType("weedrace_rearm_demo")
    mod.mu = sync_seam.REAL_LOCK()
    mod.rmu = sync_seam.REAL_RLOCK()
    mod.ev = sync_seam.REAL_EVENT()  # events are not rearmed (yet)
    mod.data = {}
    assert sync_seam.rearm_module_locks(mod) == 2
    assert isinstance(mod.mu, sync_seam.InstrumentedLock)
    assert isinstance(mod.rmu, sync_seam.InstrumentedRLock)
    # idempotent: a second pass finds nothing raw
    assert sync_seam.rearm_module_locks(mod) == 0

    held = types.ModuleType("weedrace_rearm_held")
    held.mu = sync_seam.REAL_LOCK()
    held.mu.acquire()
    try:
        with pytest.raises(RuntimeError, match="is held"):
            sync_seam.rearm_module_locks(held)
    finally:
        held.mu.release()


def test_splice_scenario_clean_after_early_import(rc, monkeypatch):
    # regression: the full test session imports filer.splice long
    # before racecheck installs, leaving _addr_lock raw — the scenario
    # rearms it, so the locked read/write pair must NOT read as a race
    import seaweedfs_tpu_torch.filer.splice  # noqa: F401  (force early import)

    from seaweedfs_tpu_torch.weedrace.scenarios import SCENARIOS
    from seaweedfs_tpu_torch.weedrace.sched import explore

    monkeypatch.setenv("WEED_RACECHECK_MODULES", "filer.splice")
    rc.reset()  # re-read the narrowed scope
    results = explore(SCENARIOS["splice_addr_cache"], bound=2, max_runs=8)
    assert results
    for r in results:
        assert not r.deadlock and not r.errors
    assert rc.report()["races"] == []


# -- the port against the JAX package ---------------------------------------
#
# The JAX package's modules are imported here, at collection, so the JAX
# seam takes its real primitives before either seam is installed.

import _thread  # noqa: E402
import dis  # noqa: E402
import subprocess  # noqa: E402
import textwrap  # noqa: E402

from seaweedfs_tpu.util import racecheck as jax_racecheck  # noqa: E402
from seaweedfs_tpu.util import sync_seam as jax_sync_seam  # noqa: E402
from weedrace.sched import explore as jax_explore  # noqa: E402

from seaweedfs_tpu_torch.weedrace.sched import explore as port_explore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
PACKAGES = {"jax": (jax_racecheck, jax_sync_seam), "port": (racecheck, sync_seam)}


class _Installed:
    """One package's racecheck installed around a block (the other's not),
    with a clean report and ``scope`` files traced."""

    def __init__(self, which: str, *scope: str, sequential: bool = False):
        self.rc, self.seam = PACKAGES[which]
        self.scope = scope
        self.sequential = sequential

    def __enter__(self):
        assert not racecheck.is_installed() and not jax_racecheck.is_installed()
        self.rc.install()
        self.rc.reset()
        for path in self.scope:
            self.rc.add_scope_file(path)
        if self.sequential:
            # each started thread runs to its end before start() returns,
            # waited for past the seam: no happens-before edge is added, but
            # the interleaving (and so each report's kind) is fixed
            self.start = threading.Thread.start
            real_join = (self.seam.real_thread_join if self.seam is sync_seam
                         else self.seam._REAL_THREAD_JOIN)

            def start(thread, _start=self.start):
                _start(thread)
                real_join(thread)

            threading.Thread.start = start
        return self.rc

    def __exit__(self, *exc):
        if self.sequential:
            threading.Thread.start = self.start
        self.rc.reset()
        self.rc.uninstall()


def _load_fixture(name: str):
    path = os.path.join(FIXTURES, name + ".py")
    spec = importlib.util.spec_from_file_location(f"weedrace_torch_fx_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return path, mod


def _norm(races: list) -> list:
    def side(s):
        return (os.path.basename(s["site"][0]), s["site"][1], s["locks"])

    return sorted((r["object"], r["attr"], r["kind"], side(r["a"]), side(r["b"])) for r in races)


@pytest.mark.parametrize("name", ["racy_pair", "locked_twin", "queue_twin",
                                  "benign_suppressed", "bare_directive"])
def test_both_packages_report_the_same_races_on_each_fixture(name, monkeypatch):
    monkeypatch.delenv("WEED_RACECHECK_MODULES", raising=False)
    reports = {}
    for which in ("jax", "port"):
        path, mod = _load_fixture(name)
        with _Installed(which, path, sequential=True) as rc:
            mod.run()
            rep = rc.report()
        reports[which] = (_norm(rep["races"]), _norm(rep["suppressed"]), rep["bare_directives"])
    assert reports["port"] == reports["jax"]
    races, suppressed, _bare = reports["port"]
    assert bool(races or suppressed) == (name in ("racy_pair", "benign_suppressed",
                                                  "bare_directive"))


def _lost_update_scenario(gate):
    class Counter:
        def __init__(self):
            self.n = 0

    obj = Counter()
    q = queue.Queue()
    q.put(None)

    def bump():
        tmp = obj.n
        q.get()
        q.put(None)
        obj.n = tmp + 1

    gate.spawn(bump, "bump-a")
    gate.spawn(bump, "bump-b")

    def check():
        assert obj.n == 2, f"lost update: n={obj.n}"

    return check


@pytest.mark.parametrize("scenario", [_two_step_scenario, _lost_update_scenario],
                         ids=["two_step", "lost_update"])
def test_the_same_explore_call_gives_the_same_schedules(scenario, monkeypatch):
    monkeypatch.delenv("WEED_RACECHECK_SCHEDULE", raising=False)
    runs = {}
    for which, explore in (("jax", jax_explore), ("port", port_explore)):
        with _Installed(which):
            results = explore(scenario, bound=2, max_runs=16)
        runs[which] = [(r.schedule_used, bool(r.errors), r.deadlock) for r in results]
    assert runs["port"] == runs["jax"]
    assert len(runs["port"]) > 1


# Queue C item 22: writes in Python 3.12 bytecode.  ``o.n += 1`` compiles to
# LOAD o; COPY 1; LOAD_ATTR n; ...; BINARY_OP; SWAP 2; STORE_ATTR n, and
# ``o.items.append(x)`` to LOAD_ATTR items; LOAD_ATTR (method) append; CALL.


class _Counter:
    def __init__(self):
        self.n = 0
        self.items = []


def _bump_aug(o):
    o.n += 1


def _bump_append(o):
    o.items.append(1)


@pytest.mark.parametrize("bump,attr", [(_bump_aug, "n"), (_bump_append, "items")],
                         ids=["augmented_assignment", "mutator_call"])
def test_a_312_write_is_a_race_only_to_the_port(bump, attr, monkeypatch):
    monkeypatch.delenv("WEED_RACECHECK_MODULES", raising=False)
    found = {}
    for which in ("jax", "port"):
        with _Installed(which, HERE) as rc:
            o = _Counter()
            ts = [threading.Thread(target=bump, args=(o,)) for _ in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            found[which] = [r for r in rc.report()["races"] if r["object"] == "_Counter"]
    assert found["jax"] == [], "the JAX detector now reads 3.12 writes: update ROADMAP item 22"
    assert [r["attr"] for r in found["port"]] == [attr], found["port"]
    r = found["port"][0]
    assert r["a"]["site"][0] == r["b"]["site"][0] == HERE


# Queue C item 23: recycled id()s.  An object that takes no attribute
# (__slots__) is keyed by id(); once it dies, a new object at its address
# inherits its shadow cells.


class _Slotted:
    __slots__ = ("x",)


def _make_and_drop(dead_ids: list) -> None:
    objs = [_Slotted() for _ in range(64)]
    for o in objs:
        o.x = 1
    dead_ids.extend(id(o) for o in objs)


def _write_at_a_dead_address(dead_ids: list, matched: list) -> None:
    dead, keep = set(dead_ids), []
    for _ in range(20_000):
        o = _Slotted()
        if id(o) in dead:
            matched.append(True)
            break
        keep.append(o)
    o.x = 2


def test_a_recycled_id_is_a_race_only_to_the_jax_detector(monkeypatch):
    monkeypatch.delenv("WEED_RACECHECK_MODULES", raising=False)
    found, reused = {}, {}
    for which in ("jax", "port"):
        with _Installed(which, HERE) as rc:
            dead_ids, matched = [], []
            done = _thread.allocate_lock()  # unseen by either seam: no edge
            done.acquire()

            def first():
                _make_and_drop(dead_ids)
                done.release()

            t1 = threading.Thread(target=first)
            t1.start()
            done.acquire()  # t1's objects are dead; t1 is not joined
            t2 = threading.Thread(target=_write_at_a_dead_address, args=(dead_ids, matched))
            t2.start()
            t2.join()
            t1.join()
            found[which] = [r for r in rc.report()["races"] if r["object"] == "_Slotted"]
            reused[which] = bool(matched)
    assert reused["jax"], "no dead address was reused: the JAX case shows nothing"
    assert found["jax"], "the JAX detector no longer aliases ids: update ROADMAP item 23"
    assert {r["attr"] for r in found["jax"]} == {"x"}
    assert found["port"] == []
    assert not reused["port"], "an object keyed by id() died while its cells lived"


def test_reset_releases_the_pinned_objects(rc):
    _make_and_drop([])
    rc.add_scope_file(HERE)
    o = _Slotted()
    o.x = 1
    assert id(o) in rc._pins
    rc.reset()
    assert rc._pins == {}


# -- Python 3.12 bytecode shapes, pinned -------------------------------------

G = []


def _shapes(o, c, i, k, b):
    o.d[k] += 1
    c[i] = o.a + b
    o.items.append(b)
    o.items.get(b)
    del o.e[k]
    y = o.f[k]
    o.g[k] = y
    G.append(1)
    G[k] = 1
    y = G[k]
    y = G
    return y


def _classified():
    insns = list(dis.get_instructions(_shapes))
    out = []
    for idx, ins in enumerate(insns):
        if ins.opname == "LOAD_ATTR" and not racecheck._is_method_load(ins):
            out.append((ins.argval, racecheck._classify_load(insns, idx)))
        elif ins.opname == "LOAD_GLOBAL" and ins.argval == "G":
            out.append(("G", racecheck._classify_global(insns, idx)))
    return out


def test_the_312_shapes_are_classified():
    assert sys.version_info[:2] == (3, 12), "the shapes pinned here are 3.12's"
    assert _classified() == [
        ("d", "write"), ("a", "read"), ("items", "write"), ("items", "read"),
        ("e", "write"), ("f", "read"), ("g", "write"),
        ("G", "write"), ("G", "write"), ("G", "read"), ("G", None),
    ]


def test_install_refuses_an_interpreter_whose_bytecode_it_cannot_read(monkeypatch):
    monkeypatch.setattr(racecheck, "BYTECODE_VERSION", (3, 11))
    lock = threading.Lock
    with pytest.raises(RuntimeError, match="bytecode only"):
        racecheck.install()
    assert not racecheck.is_installed()
    assert threading.Lock is lock and not sync_seam.installed()


# -- the pytest plugin -------------------------------------------------------


def _plugin_run(tmp_path, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WEED_LOCKCHECK", "WEED_RACECHECK",
                        "WEED_RACECHECK_MODULES")}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "seaweedfs_tpu_torch.util.checkers_pytest", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)


_PLUGIN_TEST = textwrap.dedent("""
    import threading

    from seaweedfs_tpu_torch.util import sync_seam
    from seaweedfs_tpu_torch.util.chunk_cache import ChunkCache


    def test_touch(tmp_path):
        assert threading.Lock is sync_seam.InstrumentedLock
        cache = ChunkCache(1 << 20, ram_bytes=8 << 10, directory=str(tmp_path),
                           small_max=256, max_chunk=8 << 10)
        cache.fill("7,aa", 0, 100, lambda: b"x" * 100)
        t = threading.Thread(target=lambda: cache.lookup("7,aa", 0, 100))
        t.start()
        cache.hit_rate()
        t.join()
""")


def test_the_plugin_installs_the_port_checkers_and_reports(tmp_path):
    (tmp_path / "test_plugged.py").write_text(_PLUGIN_TEST)
    proc = _plugin_run(tmp_path, "--weed-lockcheck", "--weed-racecheck", "test_plugged.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOCKCHECK: no lock-order cycles" in proc.stderr
    assert "RACECHECK: no unsuppressed races" in proc.stderr
    plain = _plugin_run(tmp_path, "test_plugged.py")  # off unless asked for
    assert plain.returncode != 0 and "LOCKCHECK" not in plain.stderr


def test_the_plugin_refuses_beside_the_jax_seam(tmp_path):
    (tmp_path / "conftest.py").write_text(
        "from seaweedfs_tpu.util import racecheck\nracecheck.install()\n")
    (tmp_path / "test_plugged.py").write_text("def test_nothing():\n    pass\n")
    proc = _plugin_run(tmp_path, "--weed-racecheck", "test_plugged.py")
    assert proc.returncode == 4, proc.stdout + proc.stderr
    assert "another instrumentation seam" in proc.stderr


def test_the_plugin_fails_a_run_that_finds_a_race(tmp_path):
    fixture = os.path.join(FIXTURES, "racy_pair.py")
    (tmp_path / "test_plugged.py").write_text(textwrap.dedent(f"""
        import importlib.util

        from seaweedfs_tpu_torch.util import racecheck


        def test_racy_pair():
            racecheck.add_scope_file({fixture!r})
            spec = importlib.util.spec_from_file_location("racy_pair", {fixture!r})
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.run()
    """))
    proc = _plugin_run(tmp_path, "--weed-racecheck", "test_plugged.py")
    assert "1 passed" in proc.stdout, proc.stdout + proc.stderr
    assert "RACE(S) DETECTED" in proc.stderr and "Shared.value" in proc.stderr
    assert proc.returncode == 1, proc.stdout + proc.stderr


@pytest.mark.parametrize("dist", [("-n", "2"), ("--dist", "loadfile", "-n", "2")])
def test_the_plugin_refuses_a_run_under_xdist(tmp_path, dist):
    (tmp_path / "test_plugged.py").write_text("def test_nothing():\n    pass\n")
    proc = _plugin_run(tmp_path, "-p", "xdist", *dist, "--weed-racecheck", "test_plugged.py")
    assert proc.returncode == 4, proc.stdout + proc.stderr
    assert "run without -n/--dist" in proc.stderr
    assert "RACECHECK" not in proc.stderr
