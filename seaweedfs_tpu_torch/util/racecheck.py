"""Happens-before data-race detector for the port's Python concurrency
plane: the port of seaweedfs_tpu/util/racecheck.py.

:func:`install` sets up a vector-clock race detector over the
``seaweedfs_tpu_torch`` package:

* **Synchronization tracking** rides the shared
  :mod:`seaweedfs_tpu_torch.util.sync_seam`: every instrumented
  ``Lock``/``RLock`` release→acquire pair, ``Condition.wait``
  release/reacquire, ``Thread.start``/``join``, ``queue.Queue``
  ``put``→``get`` handoff and ``Event.set``→``wait`` contributes a
  happens-before edge joining per-thread vector clocks.
* **Access tracking** uses a scoped ``sys.settrace`` opcode hook:
  ``LOAD_ATTR``/``STORE_ATTR``/``DELETE_ATTR`` executed by code inside
  the traced scope feed shadow cells keyed ``(object, attribute)``.
  A ``LOAD_ATTR`` immediately feeding a mutating container method
  (``.append``/``.update``/...) or a subscript store counts as a write.
  Module globals are tracked only as containers (a mutating method call
  or a subscript on the global); a rebinding such as ``n += 1`` on a
  global is not seen.
* A race is two accesses to the same cell from different threads, at
  least one a write, with *neither ordered before the other* by the
  vector clocks.  Each finding carries both stack traces, the attribute,
  and the locks held on both sides.

The bytecode shapes read are Python 3.12's (both machines that run the
port have it), and :func:`install` refuses any other interpreter:

* ``o.n += 1`` is ``LOAD o; COPY 1; LOAD_ATTR n; ...; BINARY_OP;
  SWAP 2; STORE_ATTR n``: the receiver is the load before ``COPY``, and
  the store is traced back to that ``COPY``;
* ``o.items.append(x)`` is ``LOAD_ATTR items; LOAD_ATTR append`` with
  the method bit set (``arg & 1``): a mutator name makes the first load
  a write; a method load itself is no access;
* a subscript store or delete on a loaded container is found by
  simulating the operand stack over the key expression (loads, ``COPY``,
  ``SWAP``, ``BINARY_OP``, ``BINARY_SUBSCR``, ...), so ``o.d[k] += 1``
  is a write to ``o.d`` and ``c[i] = o.a + b`` is a read of ``o.a``.

Object identity: shadow cells are keyed by a never-reused tag stored on
the object.  An object that takes no attribute (``__slots__``, builtins)
is keyed by ``id()`` and kept alive until :func:`reset`, so a dead
object's cells can never alias a new object at the same address.

Scope control: by default every module under the ``seaweedfs_tpu_torch``
package is traced, minus the checkers themselves and the ``weedrace``
harness.  ``WEED_RACECHECK_MODULES`` (or ``install(modules=...)``)
narrows that to a comma-separated list of module suffixes relative to the
package (``util.chunk_cache,stats.sketch``).  Tests can add out-of-package
files (fixtures) with :func:`add_scope_file`.

Suppressions need a justification::

    self.hits += 1  # racecheck: benign — monotonic counter, staleness ok

A bare ``# racecheck: benign`` with no reason does NOT suppress and is
itself reported (``bare_directives``).

Determinism note: the detector observes the *actual* synchronization
order of one run; schedules that never happened contribute no edges.
The ``weedrace`` explorer complements this by driving many bounded
schedules through the same instrumentation.
"""

from __future__ import annotations

import dis
import linecache
import os
import re
import sys
import threading

from seaweedfs_tpu_torch.util import sync_seam

_REAL_LOCK = sync_seam.REAL_LOCK

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF_FILES = {
    os.path.abspath(__file__),
    os.path.abspath(sync_seam.__file__),
    os.path.join(_PKG_ROOT, "util", "lockcheck.py"),
    os.path.join(_PKG_ROOT, "util", "checkers_pytest.py"),
}
# the explorer and its scenarios: harness state, never the code under test
_SELF_DIRS = (os.path.join(_PKG_ROOT, "weedrace") + os.sep,)

# -- global analysis state (guarded by a REAL lock; never recurses) ---------

_mu = _REAL_LOCK()
_installed = False
_next_tid = [1]
_tls = threading.local()

_next_tag = [0]
_cells: dict[tuple, "_Cell"] = {}
_pins: dict[int, object] = {}  # id() -> object keyed by id(), alive until reset
_races: list[dict] = []
_race_keys: set = set()
_queue_clock_attr = "_racecheck_clocks"
_MAX_CELLS = 200_000
_MAX_RACES = 500
_dropped_cells = 0

# scope: file path -> bool decision cache, plus module-suffix allowlist
_scope_cache: dict[str, bool] = {}
_scope_suffixes: tuple[str, ...] | None = None
_scope_override: str | None = None
_extra_scope_files: set[str] = set()

_SUPPRESS_RE = re.compile(r"#\s*racecheck:\s*benign(.*)$")


class _Cell:
    __slots__ = ("write", "reads")

    def __init__(self):
        self.write = None  # (tid, clk, info) of last write
        self.reads = {}  # tid -> (clk, info) reads since last write


# -- vector clocks ----------------------------------------------------------


def _join(into: dict, other: dict) -> None:
    for k, v in other.items():
        if v > into.get(k, 0):
            into[k] = v


def _thread_state():
    st = getattr(_tls, "rc", None)
    if st is None:
        with _mu:
            tid = _next_tid[0]
            _next_tid[0] += 1
        st = _tls.rc = {"tid": tid, "clock": {tid: 1}}
        t = sync_seam.current_thread_or_none()
        start = getattr(t, "_racecheck_start_clock", None)
        if start is not None:
            _join(st["clock"], start)
    return st


def current_clock() -> dict:
    """Copy of the calling thread's vector clock (for tests)."""
    st = _thread_state()
    return dict(st["clock"])


def _tick(st) -> None:
    st["clock"][st["tid"]] = st["clock"].get(st["tid"], 0) + 1


def _obj_vc(obj, attr: str = "_racecheck_vc") -> dict:
    vc = getattr(obj, attr, None)
    if vc is None:
        vc = {}
        try:
            object.__setattr__(obj, attr, vc)
        except (AttributeError, TypeError):  # pragma: no cover - slots
            return {}
    return vc


class _RacecheckListener:
    """Seam listener translating sync events into vector-clock edges."""

    # release/acquire over a lock
    def lock_acquired(self, lock, site, held_sites, record_edges, reentry):
        st = _thread_state()
        with _mu:
            _join(st["clock"], _obj_vc(lock))

    def lock_released(self, lock, site, held_for, reentry):
        st = _thread_state()
        with _mu:
            _join(_obj_vc(lock), st["clock"])
        _tick(st)

    # Condition.wait drops and re-takes the wrapped lock: same edges.
    # notify→wait-return ordering flows through the lock's clock (the
    # notifier held the lock while mutating the waited-on state).
    def lock_wait_release(self, lock):
        st = _thread_state()
        with _mu:
            _join(_obj_vc(lock), st["clock"])
        _tick(st)

    def lock_wait_reacquire(self, lock):
        st = _thread_state()
        with _mu:
            _join(st["clock"], _obj_vc(lock))

    # fork/join edges
    def thread_start(self, parent, thread):
        st = _thread_state()
        thread._racecheck_start_clock = dict(st["clock"])
        _tick(st)

    def thread_run_begin(self, thread):
        # explicit join: the thread's TLS state may already exist — its
        # own bootstrap window (``_started.set()``) fires seam events
        # before registration, ahead of this callback
        st = _thread_state()
        start = getattr(thread, "_racecheck_start_clock", None)
        if start is not None:
            _join(st["clock"], start)

    def thread_run_end(self, thread):
        st = _thread_state()
        thread._racecheck_final_clock = dict(st["clock"])

    def thread_joined(self, caller, thread):
        final = getattr(thread, "_racecheck_final_clock", None)
        if final is not None:
            st = _thread_state()
            _join(st["clock"], final)

    # queue handoff: per-item clock snapshots (FIFO pairing)
    def queue_put(self, q):
        st = _thread_state()
        with _mu:
            clocks = getattr(q, _queue_clock_attr, None)
            if clocks is None:
                clocks = []
                try:
                    setattr(q, _queue_clock_attr, clocks)
                except (AttributeError, TypeError):  # pragma: no cover
                    return
            clocks.append(dict(st["clock"]))
        _tick(st)

    def queue_get(self, q):
        st = _thread_state()
        with _mu:
            clocks = getattr(q, _queue_clock_attr, None)
            if clocks:
                _join(st["clock"], clocks.pop(0))

    # event set→wait
    def event_set(self, event):
        st = _thread_state()
        with _mu:
            _join(_obj_vc(event), st["clock"])
        _tick(st)

    def event_wait_return(self, event):
        st = _thread_state()
        with _mu:
            _join(st["clock"], _obj_vc(event))


_listener = _RacecheckListener()


# -- scope ------------------------------------------------------------------


def _configure_scope() -> None:
    global _scope_suffixes
    raw = _scope_override
    if raw is None:
        raw = os.environ.get("WEED_RACECHECK_MODULES", "")
    raw = raw.strip()
    if raw:
        _scope_suffixes = tuple(
            m.strip().replace(".", os.sep) for m in raw.split(",") if m.strip()
        )
    else:
        _scope_suffixes = None
    _scope_cache.clear()


def add_scope_file(path: str) -> None:
    """Trace an out-of-package file (test fixtures)."""
    _extra_scope_files.add(os.path.abspath(path))
    _scope_cache.clear()


def _in_scope(filename: str) -> bool:
    dec = _scope_cache.get(filename)
    if dec is not None:
        return dec
    path = os.path.abspath(filename)
    if path in _extra_scope_files:
        dec = True
    elif (path in _SELF_FILES or path.startswith(_SELF_DIRS)
          or not path.startswith(_PKG_ROOT + os.sep)):
        dec = False
    elif _scope_suffixes is None:
        dec = True
    else:
        stem = path[:-3] if path.endswith(".py") else path
        dec = any(stem.endswith(os.sep + sfx) for sfx in _scope_suffixes)
    _scope_cache[filename] = dec
    return dec


# -- opcode-level access tracking -------------------------------------------

BYTECODE_VERSION = (3, 12)  # the only bytecode the shapes below read; install() refuses others
_SIMPLE_LOADS = {"LOAD_FAST", "LOAD_FAST_CHECK", "LOAD_NAME", "LOAD_GLOBAL",
                 "LOAD_DEREF", "LOAD_CLASSDEREF", "LOAD_FROM_DICT_OR_DEREF"}
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse", "rotate",
}
_KEY_WINDOW = 16  # instructions simulated after a container load

_code_maps: dict = {}


def _code_map(code):
    m = _code_maps.get(code)
    if m is None:
        insns = list(dis.get_instructions(code))
        by_off = {ins.offset: i for i, ins in enumerate(insns)}
        m = _code_maps[code] = (insns, by_off)
    return m


def _resolve_name(frame, ins):
    name = ins.argval
    if name in frame.f_locals:
        return frame.f_locals[name]
    return frame.f_globals.get(name)


def _is_dup_of_top(ins) -> bool:
    return ins.opname == "COPY" and ins.arg == 1


def _is_method_load(ins) -> bool:
    """``LOAD_ATTR`` with the method bit: ``obj.name(...)``'s lookup."""
    return ins.opname == "LOAD_ATTR" and bool(ins.arg & 1)


def _resolve_receiver(frame, insns, idx, opname):
    """Object whose attribute is accessed, via the predecessor instruction.

    The receiver was pushed by a simple LOAD immediately before (plain
    load/store), or before the ``COPY 1`` of an augmented assignment.  An
    augmented assignment's store (``...; SWAP 2; STORE_ATTR a``) is traced
    back to the ``COPY 1`` that fed ``LOAD_ATTR a``.  Anything more complex
    (chained ``a.b.c``, subscripts) is conservatively skipped — the detector
    prefers silence over misattributing an access.
    """
    j = idx - 1
    if j < 0:
        return None
    prev = insns[j]
    if prev.opname in _SIMPLE_LOADS:
        return _resolve_name(frame, prev)
    if opname == "LOAD_ATTR" and _is_dup_of_top(prev) and j - 1 >= 0:
        p2 = insns[j - 1]
        if p2.opname in _SIMPLE_LOADS:
            return _resolve_name(frame, p2)
        return None
    if opname in ("STORE_ATTR", "DELETE_ATTR") and prev.opname == "SWAP":
        name = insns[idx].argval
        for k in range(j - 1, max(0, j - _KEY_WINDOW), -1):
            nxt = insns[k + 1]
            if (_is_dup_of_top(insns[k]) and nxt.opname == "LOAD_ATTR"
                    and nxt.argval == name):
                src = insns[k - 1]
                if src.opname in _SIMPLE_LOADS:
                    return _resolve_name(frame, src)
                return None
    return None


def _container_use(insns, idx):
    """What the code does with the value that ``insns[idx]`` pushed:
    "write" when a later ``STORE_SUBSCR``/``DELETE_SUBSCR`` stores into it
    (or a copy of it), "item" when only ``BINARY_SUBSCR`` reads from it,
    None otherwise.  Simulates the operand stack over the key expression;
    any instruction it does not model ends the search."""
    stack = ["?"] * 8 + ["C"]
    item = False
    for ins in insns[idx + 1 : idx + 1 + _KEY_WINDOW]:
        op = ins.opname
        if op in ("STORE_SUBSCR", "DELETE_SUBSCR"):
            return "write" if stack[-2] == "C" else ("item" if item else None)
        if op == "BINARY_SUBSCR":
            item = item or stack[-2] == "C"
            stack[-2:] = ["x"]
        elif op == "BINARY_OP":
            stack[-2:] = ["x"]
        elif op == "COPY":
            stack.append(stack[-ins.arg])
        elif op == "SWAP":
            stack[-1], stack[-ins.arg] = stack[-ins.arg], stack[-1]
        elif op == "LOAD_CONST" or op in _SIMPLE_LOADS:
            if op == "LOAD_GLOBAL" and ins.arg & 1:
                stack.append("x")  # the NULL of a call
            stack.append("x")
        elif op == "LOAD_ATTR" and not _is_method_load(ins):
            stack[-1] = "x"
        elif op in ("BUILD_TUPLE", "BUILD_STRING"):
            stack[len(stack) - ins.arg:] = ["x"]
        elif op == "FORMAT_VALUE":
            stack[-(2 if ins.arg & 4 else 1):] = ["x"]
        else:
            break
        if "C" not in stack:
            break
        if len(stack) < 4:
            stack[:0] = ["?"] * 4
    return "item" if item else None


def _classify_load(insns, idx) -> str:
    """Is this LOAD_ATTR feeding a container mutation?  read|write."""
    j = idx + 1
    if j < len(insns) and _is_method_load(insns[j]):
        return "write" if insns[j].argval in _MUTATOR_METHODS else "read"
    return "write" if _container_use(insns, idx) == "write" else "read"


def _classify_global(insns, idx):
    """Access kind for a LOAD_GLOBAL receiver: write|read|None (no access).

    A bare name load is not shared-state traffic; only a mutating method
    call, a subscript store, or a subscript read on the global container
    counts.  Plain attribute access on a global is already covered by the
    LOAD_ATTR path (the receiver resolves through ``_resolve_receiver``).
    """
    j = idx + 1
    if j < len(insns) and _is_method_load(insns[j]):
        return "write" if insns[j].argval in _MUTATOR_METHODS else "read"
    use = _container_use(insns, idx)
    return {"write": "write", "item": "read"}.get(use)


_SKIP_TYPE_MODULES = {"threading", "queue", "_thread", "_queue"}


def _trackable(obj) -> bool:
    if obj is None:
        return False
    t = type(obj)
    mod = getattr(t, "__module__", "")
    if mod in _SKIP_TYPE_MODULES:
        return False
    if t.__name__ in ("module", "type", "function", "builtin_function_or_method",
                      "method", "frame", "code"):
        return False
    if isinstance(obj, (sync_seam._InstrumentedBase, sync_seam.InstrumentedEvent)):
        return False
    return True


def _access_info(frame):
    stack = []
    f = frame
    depth = 0
    while f is not None and depth < 6:
        fn = f.f_code.co_filename
        stack.append(
            f"{os.path.basename(fn)}:{f.f_lineno} ({f.f_code.co_name})"
        )
        f = f.f_back
        depth += 1
    t = sync_seam.current_thread_or_none()
    return {
        "site": (frame.f_code.co_filename, frame.f_lineno),
        "stack": tuple(stack),
        "locks": tuple(sync_seam.held_sites()),
        "thread": t.name if t is not None else f"ident-{threading.get_ident()}",
    }


def _obj_tag(obj):
    """Stable per-object identity, or None when no more objects can be
    pinned.  ``id()`` is recycled after GC, and a recycled id would alias a
    dead object's shadow cells onto a new one, manufacturing races across
    unrelated lifetimes.  Each tracked object is tagged with a never-reused
    counter; one that rejects attributes (slots, builtins) is keyed by its
    id() and pinned alive until reset(), so that id cannot be reused while
    its cells exist."""
    tag = getattr(obj, "_racecheck_tag", None)
    if tag is None:
        with _mu:
            _next_tag[0] += 1
            tag = _next_tag[0]
        try:
            object.__setattr__(obj, "_racecheck_tag", tag)
        except (AttributeError, TypeError):
            key = id(obj)
            with _mu:
                if key not in _pins:
                    if len(_pins) >= _MAX_CELLS:
                        return None
                    _pins[key] = obj
            return ("id", key)
    return tag


def _record_access(obj, attr: str, kind: str, frame) -> None:
    global _dropped_cells
    st = _thread_state()
    tid = st["tid"]
    clock = st["clock"]
    my = clock.get(tid, 0)
    tag = _obj_tag(obj)
    with _mu:
        if tag is None:
            _dropped_cells += 1
            return
        key = (tag, type(obj).__name__, attr)
        cell = _cells.get(key)
        if cell is None:
            if len(_cells) >= _MAX_CELLS:
                _dropped_cells += 1
                return
            cell = _cells[key] = _Cell()
        info = None
        w = cell.write
        if w is not None and w[0] != tid and w[1] > clock.get(w[0], 0):
            info = _access_info(frame)
            _report_race(type(obj).__name__, attr, "write-" + kind,
                         w, (tid, my, info))
        if kind == "write":
            for rtid, (rclk, rinfo) in cell.reads.items():
                if rtid != tid and rclk > clock.get(rtid, 0):
                    if info is None:
                        info = _access_info(frame)
                    _report_race(type(obj).__name__, attr, "read-write",
                                 (rtid, rclk, rinfo), (tid, my, info))
            if info is None:
                info = _access_info(frame)
            cell.write = (tid, my, info)
            cell.reads.clear()
        else:
            if info is None:
                info = _access_info(frame)
            cell.reads[tid] = (my, info)


def _report_race(obj_type, attr, kind, a, b) -> None:
    # canonical site pair for dedup, independent of discovery order
    sa = f"{os.path.basename(a[2]['site'][0])}:{a[2]['site'][1]}"
    sb = f"{os.path.basename(b[2]['site'][0])}:{b[2]['site'][1]}"
    rk = (obj_type, attr, tuple(sorted((sa, sb))))
    if rk in _race_keys or len(_races) >= _MAX_RACES:
        return
    _race_keys.add(rk)
    _races.append({
        "object": obj_type,
        "attr": attr,
        "kind": kind,
        "a": a[2],
        "b": b[2],
    })


# -- trace hooks ------------------------------------------------------------


def _global_trace(frame, event, arg):
    if event != "call":
        return None
    if not _in_scope(frame.f_code.co_filename):
        return None
    frame.f_trace_opcodes = True
    return _local_trace


def _local_trace(frame, event, arg):
    if event != "opcode":
        return _local_trace
    try:
        insns, by_off = _code_map(frame.f_code)
        idx = by_off.get(frame.f_lasti)
        if idx is None:
            return _local_trace
        ins = insns[idx]
        op = ins.opname
        if op == "LOAD_ATTR":
            if _is_method_load(ins):
                return _local_trace  # a method lookup, not state traffic
            kind = _classify_load(insns, idx)
        elif op in ("STORE_ATTR", "DELETE_ATTR"):
            kind = "write"
        elif op == "LOAD_GLOBAL":
            # module-level container use: only a method call or subscript on
            # the global is an access — a plain value load of a name is not
            # shared-state traffic
            kind = _classify_global(insns, idx)
            if kind is None:
                return _local_trace
            obj = frame.f_globals.get(ins.argval)
            if obj is not None and _trackable(obj):
                _record_access(obj, "global:" + ins.argval, kind, frame)
            return _local_trace
        else:
            return _local_trace
        attr = ins.argval
        if attr.startswith("__") or attr.startswith("_racecheck"):
            return _local_trace
        obj = _resolve_receiver(frame, insns, idx, op)
        if obj is not None and _trackable(obj):
            _record_access(obj, attr, kind, frame)
    except Exception:  # a raising settrace callback kills the traced thread; the detector must degrade to a missed access, never take the app down
        pass
    return _local_trace


# -- suppression grammar ----------------------------------------------------


def _directive_at(path: str, line: int):
    """('ok'|'bare', line) when a benign directive covers this line."""
    for ln in (line, line - 1):
        if ln <= 0:
            continue
        text = linecache.getline(path, ln)
        m = _SUPPRESS_RE.search(text)
        if m:
            reason = m.group(1).strip().lstrip("—–:-# ").strip()
            return ("ok" if len(reason) >= 4 else "bare"), ln
    return None, 0


def _partition(raw: list[dict]):
    races, suppressed, bare = [], [], []
    for r in raw:
        verdicts = []
        for side in ("a", "b"):
            path, line = r[side]["site"]
            verdicts.append(_directive_at(path, line))
        if any(v[0] == "ok" for v in verdicts):
            suppressed.append(r)
        elif any(v[0] == "bare" for v in verdicts):
            bare.append(r)
            races.append(r)
        else:
            races.append(r)
    return races, suppressed, bare


# -- public API -------------------------------------------------------------


def is_installed() -> bool:
    return _installed


def install(modules: str | None = None) -> None:
    """Activate race detection: seam listener + scoped opcode tracing.

    ``modules`` (comma-separated suffixes relative to the package) narrows
    the scope as ``WEED_RACECHECK_MODULES`` does, and wins over it.
    Threads created *after* install are traced (``threading.settrace``);
    the installing thread is traced immediately.  Raises RuntimeError,
    and installs nothing, on an interpreter whose bytecode it does not
    read (anything but BYTECODE_VERSION) or while another seam has
    patched threading."""
    global _installed, _scope_override
    if _installed:
        return
    if sys.version_info[:2] != BYTECODE_VERSION:
        raise RuntimeError(
            f"racecheck reads Python {BYTECODE_VERSION[0]}.{BYTECODE_VERSION[1]} "
            f"bytecode only; this is {sys.version_info[0]}.{sys.version_info[1]}, "
            "where it would miss writes")
    sync_seam.install("racecheck")
    _scope_override = modules
    _configure_scope()
    sync_seam.add_listener(_listener)
    threading.settrace(_global_trace)
    sys.settrace(_global_trace)
    _installed = True


def uninstall() -> None:
    global _installed, _scope_override
    if not _installed:
        return
    sys.settrace(None)
    threading.settrace(None)  # type: ignore[arg-type]
    sync_seam.remove_listener(_listener)
    sync_seam.uninstall("racecheck")
    _scope_override = None
    _installed = False


def reset() -> None:
    """Drop every cell, race and pinned object, and read the scope again
    (``WEED_RACECHECK_MODULES`` may have changed since install)."""
    global _dropped_cells
    with _mu:
        _cells.clear()
        _pins.clear()
        _races.clear()
        _race_keys.clear()
        _dropped_cells = 0
    _configure_scope()


def report() -> dict:
    """{"races": unsuppressed, "suppressed": [...], "bare_directives": n,
    "cells": shadow cells watched, "dropped_cells": n}.

    ``races`` includes any race whose only covering directive is bare
    (no justification) — an unexplained suppression does not count."""
    with _mu:
        raw = list(_races)
        dropped = _dropped_cells
        cells = len(_cells)
    races, suppressed, bare = _partition(raw)
    return {
        "races": races,
        "suppressed": suppressed,
        "bare_directives": len(bare),
        "cells": cells,
        "dropped_cells": dropped,
    }
