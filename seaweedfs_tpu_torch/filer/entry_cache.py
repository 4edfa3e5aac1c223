"""Per-process filer entry cache for the gateway read path.

Repeated GETs of the same object resolve the filer entry from process
memory instead of the filer store: a TTL bounds staleness against
out-of-band mutations, and in-process mutations invalidate instantly
through the filer's metadata-event seam (``Filer.listeners``, the same
events the meta_log subscription streams cross-process) — the
reference's filer.remote/cache pattern, scoped to entries.

Negative lookups cache too (a hot 404 costs a dict hit, not a store
walk) under their own — typically shorter — ``neg_ttl``: a missing-key
GET storm stops paying a filer round-trip per request, while a freshly
created object becomes visible after at most ``neg_ttl`` even if every
invalidation event is lost.  Capacity is LRU-bounded so a listing sweep
cannot grow the gateway without bound.

Every cache event lands in ``weedtpu_entry_cache_total{event=...}``
(hit / neg_hit / miss / neg_miss / invalidate) — the neg_hit series is
the direct measure of the 404-storm savings.

The port's copy of seaweedfs_tpu/filer/entry_cache.py.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import replace
from typing import Callable

from seaweedfs_tpu_torch.filer.entry import Entry

_MISSING = object()  # cached negative lookup


def _clone(entry: Entry) -> Entry:
    """Defensive copy: filer stores decode a fresh Entry per lookup and
    callers mutate entries in place before update_entry — a shared cached
    object would leak half-applied mutations to concurrent readers."""
    e = replace(entry, chunks=list(entry.chunks))
    e.attr = replace(entry.attr)
    e.extended = dict(entry.extended)
    return e


class EntryCache:
    def __init__(
        self, ttl: float = 2.0, capacity: int = 8192,
        neg_ttl: float | None = None,
    ):
        self.ttl = ttl
        # negatives default to the positive TTL (the pre-neg_ttl
        # behavior); gateways pass a short one so hot-404 storms are
        # absorbed without making object creation look slow
        self.neg_ttl = ttl if neg_ttl is None else neg_ttl
        self.capacity = capacity
        self._cache: OrderedDict[str, tuple[float, object]] = OrderedDict()
        self._lock = threading.Lock()
        # lost-invalidation guard, per path: a load whose OWN path was
        # invalidated while the store read was in flight is not inserted
        # (the read may predate the mutation), but mutations of other
        # paths never block population — the hit rate survives mixed
        # read/write load.  Both dicts are bounded by concurrent loads.
        self._inflight: dict[str, int] = {}  # path -> loads in flight
        self._dirty: set[str] = set()  # invalidated while loading
        self.hits = 0
        self.neg_hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(
        self, path: str, loader: Callable[[str], Entry | None]
    ) -> Entry | None:
        from seaweedfs_tpu_torch import stats

        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None and hit[0] > now:
                self._cache.move_to_end(path)
                val = hit[1]
                if val is _MISSING:
                    self.neg_hits += 1
                else:
                    self.hits += 1
            else:
                val = None
                self._inflight[path] = self._inflight.get(path, 0) + 1
        if val is not None:
            stats.ENTRY_CACHE.inc(
                event="neg_hit" if val is _MISSING else "hit"
            )
            # clone OUTSIDE the lock: a hot many-chunk entry must not
            # serialize every reader behind one O(chunks) copy
            return None if val is _MISSING else _clone(val)  # type: ignore[arg-type]
        try:
            entry = loader(path)
        except BaseException:
            # the in-flight marker must not leak on a store blip, or the
            # path's _dirty flag could never clear again
            with self._lock:
                self._load_done_locked(path)
            raise
        stored = _clone(entry) if entry is not None else _MISSING
        expiry = now + (self.ttl if entry is not None else self.neg_ttl)
        with self._lock:
            self.misses += 1
            raced = self._load_done_locked(path)
            if not raced:
                self._cache[path] = (expiry, stored)
                self._cache.move_to_end(path)
                while len(self._cache) > self.capacity:
                    self._cache.popitem(last=False)
        stats.ENTRY_CACHE.inc(
            event="miss" if entry is not None else "neg_miss"
        )
        return entry

    def _load_done_locked(self, path: str) -> bool:
        """Retire one in-flight load; returns True when an invalidation
        raced it (the load must not populate the cache)."""
        left = self._inflight.get(path, 1) - 1
        if left:
            self._inflight[path] = left
        else:
            self._inflight.pop(path, None)
        raced = path in self._dirty
        if raced and not left:
            self._dirty.discard(path)
        return raced

    def invalidate(self, path: str) -> None:
        from seaweedfs_tpu_torch import stats

        dropped = False
        with self._lock:
            if path in self._inflight:
                self._dirty.add(path)  # racing load must not be cached
            if self._cache.pop(path, None) is not None:
                self.invalidations += 1
                dropped = True
        if dropped:
            stats.ENTRY_CACHE.inc(event="invalidate")

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._cache),
                "hits": self.hits,
                "neg_hits": self.neg_hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }

    # ---- invalidation seam ----------------------------------------------
    def attach(self, filer) -> None:
        """Subscribe to an in-process Filer's mutation events so every
        create/update/delete/rename drops the affected paths before the
        mutating call returns."""
        filer.listeners.append(self._on_event)

    def _on_event(self, ev) -> None:
        for entry in (ev.old_entry, ev.new_entry):
            if entry is not None:
                self.invalidate(entry.full_path)
        if ev.new_parent_path and ev.new_entry is not None:
            # renames re-home the entry; the event's new_entry already
            # carries the destination path, but cover the source-dir
            # composition too in case a store emits pre-move paths
            name = ev.new_entry.full_path.rsplit("/", 1)[-1]
            self.invalidate(ev.new_parent_path.rstrip("/") + "/" + name)
