"""Opt-in instrumented locks: lock-order-cycle (deadlock) detection; the
port of seaweedfs_tpu/util/lockcheck.py.

:func:`install` replaces ``threading.Lock``/``threading.RLock`` with
wrappers that record, per thread, which lock classes are held when another
is acquired.  Lock *classes* are allocation sites (``file:line``), like the
kernel's lockdep: every ``Volume._write_lock`` is one node regardless of
how many volumes exist, so an AB–BA inversion between two volume locks is
still caught.

The wrappers build a directed graph ``held_site → acquired_site``; a cycle
in that graph is a potential deadlock even if no run ever deadlocked.
They also flag holds longer than ``WEED_LOCKCHECK_HOLD_MS`` (default 500)
— a lock held across blocking I/O is the usual culprit.

The primitive patching lives in the shared
:mod:`seaweedfs_tpu_torch.util.sync_seam`: lockcheck is one *listener* on
that seam, :mod:`seaweedfs_tpu_torch.util.racecheck` is another, and both
on at once compose over a single install.

Usage::

    python -m pytest -p seaweedfs_tpu_torch.util.checkers_pytest --weed-lockcheck tests/...
    # at session end the plugin prints "LOCKCHECK: ..."

or programmatically::

    from seaweedfs_tpu_torch.util import lockcheck
    lockcheck.install()
    ... run workload ...
    report = lockcheck.report()   # {"cycles": [...], "held_too_long": [...]}
    lockcheck.uninstall()
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch.util import sync_seam

_REAL_LOCK = sync_seam.REAL_LOCK
_REAL_RLOCK = sync_seam.REAL_RLOCK

# The wrapper classes ARE the seam's: one instrumented lock type serves
# every listener.
CheckedLock = sync_seam.InstrumentedLock
CheckedRLock = sync_seam.InstrumentedRLock

# global state is guarded by a REAL lock so instrumentation never recurses
_state_mu = _REAL_LOCK()
_edges: dict[str, set[str]] = {}  # held site -> sites acquired while held
_edge_threads: dict[tuple[str, str], str] = {}  # first thread seen per edge
_held_too_long: list[tuple[str, float]] = []  # (site, seconds)
_installed = False

HOLD_THRESHOLD = float(os.environ.get("WEED_LOCKCHECK_HOLD_MS", "500")) / 1000.0
_MAX_HOLD_RECORDS = 200


class _LockcheckListener:
    """Seam listener: lock-order edges + hold-duration records."""

    def lock_acquired(self, lock, site, held_sites, record_edges, reentry):
        # trylocks (blocking=False) never wait, so they cannot deadlock:
        # like lockdep, they contribute no wait-for edges (hold-duration
        # bookkeeping still applies)
        if reentry or not record_edges or not held_sites:
            return
        t = sync_seam.current_thread_or_none()
        name = t.name if t is not None else f"ident-{threading.get_ident()}"
        with _state_mu:
            for held in held_sites:
                if held != site:
                    _edges.setdefault(held, set()).add(site)
                    _edge_threads.setdefault((held, site), name)

    def lock_released(self, lock, site, held_for, reentry):
        # module-global lookup so tests can monkeypatch HOLD_THRESHOLD
        if not reentry and held_for > HOLD_THRESHOLD:
            with _state_mu:
                if len(_held_too_long) < _MAX_HOLD_RECORDS:
                    _held_too_long.append((site, held_for))


_listener = _LockcheckListener()
# Always listening: bare CheckedLock construction (no install) records
# globally.
sync_seam.add_listener(_listener)


# -- analysis ---------------------------------------------------------------


def cycles() -> list[list[str]]:
    """Simple cycles in the lock-order graph (each reported once)."""
    with _state_mu:
        graph = {k: sorted(v) for k, v in _edges.items()}
    seen_cycles: set[tuple[str, ...]] = set()
    out: list[list[str]] = []

    def dfs(node: str, path: list[str], on_path: set[str], visited: set[str]):
        visited.add(node)
        on_path.add(node)
        path.append(node)
        for nxt in graph.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                # canonicalize rotation so A->B->A and B->A->B dedupe
                pivot = cyc.index(min(cyc))
                key = tuple(cyc[pivot:] + cyc[:pivot])
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    out.append(list(key))
            elif nxt not in visited:
                dfs(nxt, path, on_path, visited)
        path.pop()
        on_path.discard(node)

    visited: set[str] = set()
    for node in sorted(graph):
        if node not in visited:
            dfs(node, [], set(), visited)
    return out


def report() -> dict:
    with _state_mu:
        edges = {k: sorted(v) for k, v in _edges.items()}
        held = sorted(_held_too_long, key=lambda x: -x[1])
    return {
        "edges": edges,
        "cycles": cycles(),
        "held_too_long": [
            {"site": s, "seconds": round(d, 3)} for s, d in held
        ],
    }


def reset() -> None:
    with _state_mu:
        _edges.clear()
        _edge_threads.clear()
        del _held_too_long[:]


# -- installation -----------------------------------------------------------


def install() -> None:
    """Patch threading.Lock/RLock so every lock created afterwards is
    instrumented.  Locks created before install stay plain.  Raises
    RuntimeError while another seam has patched threading."""
    global _installed
    if _installed:
        return
    sync_seam.install("lockcheck")
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    sync_seam.uninstall("lockcheck")
    _installed = False
