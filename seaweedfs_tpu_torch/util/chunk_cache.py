"""Per-gateway hot-chunk cache: S3-FIFO admission over mmap'd segment files.

The paper's Haystack lineage assumes a cache tier in front of the needle
store — the O(1)-disk-read design serves the *long tail*, with hot reads
absorbed upstream.  This module is that tier for the gateway: a
per-worker cache of chunk bodies keyed by ``(fid, lo, hi)`` so a warm
GET never opens an upstream connection or touches the volume server.

Admission is S3-FIFO (Yang et al., SOSP'23 — the FIFO-queues-beat-LRU
result): new entries enter a small probationary FIFO (~10% of the byte
budget); entries evicted from it untouched go to a *ghost* list (keys
only) and are only promoted into the main FIFO when they return — so a
one-hit-wonder scan (a listing sweep, a backup walk) flows through the
small queue without ever displacing the hot set.  Main-queue eviction
gives each entry ``freq`` second chances (lazy promotion), the paper's
quick-demotion + lazy-promotion pair.

Storage is two-tier:

* small objects (<= ``small_max``, the 4–64 KiB Haystack regime) live in
  an in-RAM tier bounded by ``ram_bytes`` — a hit is a dict lookup and a
  ``bytes`` reference, served straight from the handler;
* larger chunks land in mmap'd **segment files** bump-allocated under
  ``WEED_CHUNK_CACHE_MB``.  Segment files are unlinked at creation (the
  fd + mmap keep them alive), so a SIGKILL'd worker leaks nothing to
  disk.  A hit hands out a dup'd fd + file offset, which the gateway
  reads with ``pread`` (the JAX package's native plane relays it with
  ``sendfile(2)``; the port has no native plane), and because
  S3-FIFO's queues ARE FIFOs, promotions copy forward into the active
  segment and the oldest segments drain to zero live entries and are
  reclaimed whole.

Coherence: fids are immutable (a needle is never rewritten under the
same fid), so correctness never depends on invalidation — a cached body
for a live fid is always byte-exact.  Invalidation (``invalidate_fid``)
reclaims bytes on delete/overwrite events from the filer's in-process
listeners and the ``meta_subscriber`` stream, with an optional
per-entry TTL as the backstop.  Fills are single-flight: concurrent
misses on one key fetch once.

Every event lands in ``weedtpu_chunk_cache_total{event=...}`` (hit /
miss / admit / reject / evict / invalidate) and the held bytes in
``weedtpu_chunk_cache_bytes{tier=ram|segment}``; ``debug_snapshot()``
renders the full snapshot.

The port's copy of seaweedfs_tpu/util/chunk_cache.py.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

from seaweedfs_tpu_torch.util import wlog

# queue tags
_SMALL, _MAIN = 0, 1
# freq cap: S3-FIFO's lazy promotion needs only a tiny counter (the
# paper uses 2 bits); capping keeps one hot entry from pinning the main
# queue for an unbounded number of reinsert rounds
_FREQ_CAP = 3
# how long a single-flight waiter parks on another thread's fill before
# concluding the filler is wedged and fetching for itself
_FILL_WAIT_S = 10.0


@dataclass
class CacheHit:
    """One served cache hit.  Exactly one of ``data`` / ``fd`` is the
    payload: RAM-tier hits carry immutable ``bytes``; segment-tier hits
    carry a dup'd file descriptor + offset for ``sendfile(2)`` (close it
    via :meth:`close` when done — eviction can retire the segment's own
    fd mid-send, the dup keeps the unlinked file alive)."""

    size: int
    data: bytes | None = None
    fd: int = -1
    file_off: int = 0

    def bytes_view(self) -> bytes:
        """Materialize the payload (Python-path serving / parity tests)."""
        if self.data is not None:
            return self.data
        return os.pread(self.fd, self.size, self.file_off)

    def close(self) -> None:
        if self.fd >= 0:
            try:
                os.close(self.fd)
            except OSError:
                pass
            self.fd = -1


class _Segment:
    """One unlinked, mmap'd, bump-allocated segment file."""

    def __init__(self, directory: str, size: int, seg_id: int):
        fd = -1
        path = None
        try:
            fd, path = tempfile.mkstemp(
                prefix=f"weed-chunk-cache-{seg_id:06d}-", dir=directory
            )
            os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        except BaseException:
            if fd >= 0:
                os.close(fd)
                if path is not None:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            raise
        # unlink immediately: the fd + mapping keep the file alive, and a
        # SIGKILL'd worker leaves nothing behind to sweep
        os.unlink(path)
        self.fd = fd
        self.id = seg_id
        self.size = size
        self.used = 0  # bump pointer
        self.live = 0  # entries still referencing this segment

    def close(self) -> None:
        try:
            self.mm.close()
        finally:
            os.close(self.fd)


class _Entry:
    __slots__ = ("key", "size", "freq", "queue", "data", "seg", "off",
                 "expires")

    def __init__(self, key, size):
        self.key = key
        self.size = size
        self.freq = 0
        self.queue = _SMALL
        self.data: bytes | None = None  # RAM tier
        self.seg: _Segment | None = None  # segment tier
        self.off = 0
        self.expires = 0.0  # monotonic deadline; 0 = immutable, no TTL


class ChunkCache:
    """S3-FIFO chunk cache (see module docstring).  Thread-safe; all
    sizing is bytes.  ``capacity_bytes`` bounds the segment tier's disk
    footprint, ``ram_bytes`` the in-RAM small-object tier."""

    def __init__(
        self,
        capacity_bytes: int,
        *,
        ram_bytes: int | None = None,
        directory: str | None = None,
        segment_bytes: int = 8 << 20,
        small_max: int = 64 * 1024,
        max_chunk: int = 2 << 20,
        ttl: float = 0.0,
        ghost_entries: int = 16384,
    ):
        self.capacity = max(int(capacity_bytes), 1 << 20)
        self.ram_capacity = (
            min(32 << 20, self.capacity) if ram_bytes is None
            else int(ram_bytes)
        )
        self.segment_bytes = min(max(segment_bytes, max_chunk), self.capacity)
        self.small_max = small_max
        self.max_chunk = min(max_chunk, self.segment_bytes)
        self.ttl = ttl
        self.directory = directory or tempfile.gettempdir()
        # disk serializer: segment roll-over opens/maps a file while
        # held; no network ever runs under it (loads happen outside)
        self._io_lock = threading.Lock()
        self._entries: dict[tuple, _Entry] = {}
        self._small: deque = deque()
        self._main: deque = deque()
        self._ghost: OrderedDict[tuple, None] = OrderedDict()
        self._ghost_by_fid: dict[str, set] = {}  # O(1) invalidation
        self._ghost_cap = ghost_entries
        self._by_fid: dict[str, set] = {}
        # manifest lineage: parent (manifest) fid -> data-chunk fids it
        # expands to, so deleting a manifest-backed object reclaims the
        # DATA ranges the cache actually holds (events only carry the
        # top-level chunk list).  Bounded like the ghost list.
        self._aliases: OrderedDict[str, set] = OrderedDict()
        self._segments: dict[int, _Segment] = {}
        self._active: _Segment | None = None
        self._next_seg_id = 0
        self._ram_used = 0
        self._seg_live_bytes = 0  # logical bytes of live segment entries
        self._small_bytes = 0  # both tiers, small queue only
        self._inflight: dict[tuple, threading.Event] = {}
        self._closed = False
        # local counters (the /metrics family aggregates process-wide;
        # these back stats()/debug and the cache hit rate)
        self.hits = 0
        self.misses = 0
        self.admits = 0
        self.rejects = 0
        self.evictions = 0
        self.invalidations = 0
        self.hit_bytes = 0
        self.fill_bytes = 0
        _track(self)

    # ---- env factory ------------------------------------------------------

    @classmethod
    def from_env(cls) -> "ChunkCache | None":
        """A cache sized by ``WEED_CHUNK_CACHE_MB`` (0/unset disables);
        the knobs below tune the tiers:

        - ``WEED_CHUNK_CACHE_RAM_MB``: in-RAM small-object tier bytes
        - ``WEED_CHUNK_CACHE_SMALL_KB``: RAM-tier upper object size
        - ``WEED_CHUNK_CACHE_MAX_CHUNK_KB``: largest cacheable chunk
        - ``WEED_CHUNK_CACHE_TTL_S``: per-entry TTL backstop (0 = off,
          fids are immutable)
        - ``WEED_CHUNK_CACHE_DIR``: segment file placement
        """
        try:
            mb = float(os.environ.get("WEED_CHUNK_CACHE_MB", "0") or 0)
        except ValueError:
            mb = 0.0
        if mb <= 0:
            return None
        kwargs: dict = {}
        ram = os.environ.get("WEED_CHUNK_CACHE_RAM_MB")
        if ram:
            kwargs["ram_bytes"] = int(float(ram) * (1 << 20))
        small = os.environ.get("WEED_CHUNK_CACHE_SMALL_KB")
        if small:
            kwargs["small_max"] = int(float(small) * 1024)
        max_kb = os.environ.get("WEED_CHUNK_CACHE_MAX_CHUNK_KB")
        if max_kb:
            kwargs["max_chunk"] = int(float(max_kb) * 1024)
        ttl = os.environ.get("WEED_CHUNK_CACHE_TTL_S")
        if ttl:
            kwargs["ttl"] = float(ttl)
        if os.environ.get("WEED_CHUNK_CACHE_DIR"):
            kwargs["directory"] = os.environ["WEED_CHUNK_CACHE_DIR"]
        return cls(int(mb * (1 << 20)), **kwargs)

    # ---- lookups ----------------------------------------------------------

    def cacheable(self, size: int) -> bool:
        return 0 < size <= self.max_chunk

    def contains(self, fid: str, lo: int, hi: int) -> bool:
        """Non-counting peek (response-header attribution): is the range
        present and unexpired right now?  Never bumps freq or hit/miss
        counters — the serving lookup does that once."""
        with self._io_lock:
            e = self._entries.get((fid, lo, hi))
            return e is not None and not (
                e.expires and time.monotonic() >= e.expires
            )

    def lookup(self, fid: str, lo: int, hi: int) -> CacheHit | None:
        """A hit handle for chunk-range [lo, hi] of ``fid``, or None.
        Segment-tier handles carry a dup'd fd — close them after the
        send."""
        from seaweedfs_tpu_torch import stats

        key = (fid, lo, hi)
        hit: CacheHit | None = None
        with self._io_lock:
            e = self._entries.get(key)
            if e is not None and e.expires and time.monotonic() >= e.expires:
                self._remove_locked(e, ghost=False)
                e = None
            if e is not None:
                e.freq = min(e.freq + 1, _FREQ_CAP)
                self.hits += 1
                self.hit_bytes += e.size
                if e.data is not None:
                    hit = CacheHit(size=e.size, data=e.data)
                else:
                    try:
                        hit = CacheHit(
                            size=e.size, fd=os.dup(e.seg.fd), file_off=e.off
                        )
                    except OSError:  # fd table exhausted: serve a copy
                        hit = CacheHit(
                            size=e.size,
                            data=bytes(e.seg.mm[e.off : e.off + e.size]),
                        )
            else:
                self.misses += 1
        stats.CHUNK_CACHE.inc(event="hit" if hit is not None else "miss")
        return hit

    # ---- fills ------------------------------------------------------------

    def fill(self, fid: str, lo: int, hi: int, loader) -> bytes:
        """Single-flight fill: load chunk-range [lo, hi] via ``loader()``
        (a zero-arg callable returning bytes), admit it, and return the
        bytes.  Concurrent misses on the same key wait for the first
        loader instead of stampeding the volume server; a failed load
        propagates to its own caller and releases the waiters to fetch
        for themselves."""
        key = (fid, lo, hi)
        while True:
            with self._io_lock:
                e = self._entries.get(key)
                if e is not None and not (
                    e.expires and time.monotonic() >= e.expires
                ):
                    e.freq = min(e.freq + 1, _FREQ_CAP)
                    if e.data is not None:
                        return e.data
                    return bytes(e.seg.mm[e.off : e.off + e.size])
                waiter = self._inflight.get(key)
                if waiter is None:
                    self._inflight[key] = threading.Event()
                    break
            # someone else is filling: wait bounded, then re-check.  A
            # wait that TIMES OUT means the filler is wedged (stuck
            # upstream, or died between registering and its finally) —
            # fetch for ourselves instead of re-waiting forever: one
            # stuck fetch must not pile every reader of a hot key up
            # behind it
            if not waiter.wait(timeout=_FILL_WAIT_S):
                return loader()
        try:
            data = loader()
        except BaseException:
            with self._io_lock:
                ev = self._inflight.pop(key, None)
            if ev is not None:
                ev.set()
            raise
        self.insert(fid, lo, hi, data)
        with self._io_lock:
            self.fill_bytes += len(data)
            ev = self._inflight.pop(key, None)
        if ev is not None:
            ev.set()
        return data

    def insert(self, fid: str, lo: int, hi: int, data: bytes) -> bool:
        """Admit one chunk range.  Returns False when rejected (too
        large, or eviction could not clear space)."""
        from seaweedfs_tpu_torch import stats

        size = len(data)
        key = (fid, lo, hi)
        if not self.cacheable(size):
            stats.CHUNK_CACHE.inc(event="reject")
            with self._io_lock:
                self.rejects += 1
            return False
        with self._io_lock:
            if self._closed or key in self._entries:
                return False
            e = _Entry(key, size)
            if self.ttl > 0:
                e.expires = time.monotonic() + self.ttl
            # ghost hit -> straight into main (the S3-FIFO promotion);
            # fresh keys take the small probationary queue
            ghosted = self._ghost.pop(key, _MISSING) is not _MISSING
            if ghosted:
                self._ghost_fid_discard_locked(key)
            e.queue = _MAIN if ghosted else _SMALL
            if not self._store_locked(e, data):
                stats_event = "reject"
                self.rejects += 1
            else:
                self._entries[key] = e
                self._by_fid.setdefault(fid, set()).add(key)
                (self._main if e.queue == _MAIN else self._small).append(key)
                if e.queue == _SMALL:
                    self._small_bytes += size
                stats_event = "admit"
                self.admits += 1
        stats.CHUNK_CACHE.inc(event=stats_event)
        return stats_event == "admit"

    # ---- S3-FIFO internals (all _locked) ----------------------------------

    def _store_locked(self, e: _Entry, data: bytes) -> bool:
        """Place the payload (RAM or active segment), evicting to make
        room.  False = space could not be cleared (admission rejected)."""
        if e.size <= self.small_max:
            if not self._evict_until_locked(lambda: (
                self._ram_used + e.size <= self.ram_capacity
            )):
                return False
            e.data = bytes(data)
            self._ram_used += e.size
            return True
        if not self._evict_until_locked(lambda: self._seg_fits_locked(e.size)):
            return False
        seg = self._seg_alloc_locked(e.size)
        seg.mm[seg.used : seg.used + e.size] = data
        e.seg, e.off = seg, seg.used
        seg.used += e.size
        seg.live += 1
        self._seg_live_bytes += e.size
        return True

    def _seg_fits_locked(self, size: int) -> bool:
        """Would a ``size``-byte allocation fit the disk budget without a
        new over-cap segment?  A zero-live active segment does not count
        against the budget — rollover reclaims it (``_seg_alloc_locked``)
        the moment a new segment takes over, so charging it would wedge
        the whole tier at ``capacity < 2*segment_bytes``: the sole full
        segment could never be replaced even after every entry died."""
        if self._active is not None and (
            self._active.size - self._active.used >= size
        ):
            return True
        nseg = len(self._segments) + 1
        if self._active is not None and self._active.live <= 0:
            nseg -= 1
        return nseg * self.segment_bytes <= self.capacity

    def _seg_alloc_locked(self, size: int) -> _Segment:
        if self._active is None or self._active.size - self._active.used < size:
            old = self._active
            seg = _Segment(self.directory, self.segment_bytes,
                           self._next_seg_id)
            self._next_seg_id += 1
            self._segments[seg.id] = seg
            self._active = seg
            # an active segment whose entries all died pre-rollover was
            # protected from release (its bump pointer was in use);
            # reclaim it NOW or it is stranded forever — release only
            # runs on entry removal and no entry references it.  Never
            # reuse the file in place: outstanding dup'd hit fds still
            # read the old bytes, and closing (not rewriting) keeps them
            # intact until the last dup closes.
            if old is not None and old.live <= 0:
                self._segments.pop(old.id, None)
                old.close()
                from seaweedfs_tpu_torch.stats import events

                events.record(
                    events.CACHE_SEGMENT_RECLAIM, segment=old.id,
                    bytes=old.used, reason="rollover_dead",
                )
        return self._active

    def _seg_release_locked(self, seg: _Segment) -> None:
        seg.live -= 1
        if seg.live <= 0 and seg is not self._active:
            self._segments.pop(seg.id, None)
            seg.close()
            from seaweedfs_tpu_torch.stats import events

            events.record(
                events.CACHE_SEGMENT_RECLAIM, segment=seg.id,
                bytes=seg.used, reason="emptied",
            )

    def _evict_until_locked(self, fits) -> bool:
        # termination: every round either removes an entry or decrements
        # a bounded freq, so at most entries * (_FREQ_CAP + 1) rounds
        rounds = (len(self._entries) + 1) * (_FREQ_CAP + 1)
        while not fits():
            if rounds <= 0 or not self._evict_one_locked():
                return False
            rounds -= 1
        return True

    def _evict_one_locked(self) -> bool:
        from seaweedfs_tpu_torch import stats

        # quick demotion: the probationary queue evicts first while it
        # holds more than the S3-FIFO ~10% share of the bytes actually
        # cached (a fixed target would misroute pressure whenever one
        # tier's budget dwarfs the other's) — main eviction is the
        # lazy-promotion loop
        used = self._ram_used + self._seg_live_bytes
        if self._small and (self._small_bytes * 10 > used
                            or not self._main):
            key = self._small.popleft()
            e = self._entries.get(key)
            if e is None or e.queue != _SMALL:
                return bool(self._entries)  # stale queue token
            if e.freq >= 1:
                # touched while on probation: promote (segment entries
                # copy forward so old segments drain to zero and free)
                self._small_bytes -= e.size
                e.queue = _MAIN
                self._promote_storage_locked(e)
                self._main.append(key)
                return True
            self._remove_locked(e, ghost=True)  # decrements _small_bytes
            stats.CHUNK_CACHE.inc(event="evict")
            self.evictions += 1
            return True
        if not self._main:
            return False
        key = self._main.popleft()
        e = self._entries.get(key)
        if e is None or e.queue != _MAIN:
            return bool(self._entries)
        if e.freq >= 1:
            e.freq -= 1
            self._promote_storage_locked(e)
            self._main.append(key)
            return True
        self._remove_locked(e, ghost=False)
        stats.CHUNK_CACHE.inc(event="evict")
        self.evictions += 1
        return True

    def _promote_storage_locked(self, e: _Entry) -> None:
        """Copy a surviving segment entry forward into the active segment
        so eviction order stays segment order and the oldest segments
        always drain whole.  RAM entries move queues for free.  When no
        fresh segment space exists the entry stays put (an old pinned
        segment beats dropping a proven-hot entry)."""
        if e.seg is None or e.seg is self._active:
            return
        if not self._seg_fits_locked(e.size):
            return
        seg = self._seg_alloc_locked(e.size)
        if seg is e.seg:
            return
        seg.mm[seg.used : seg.used + e.size] = e.seg.mm[e.off : e.off + e.size]
        old = e.seg
        e.seg, e.off = seg, seg.used
        seg.used += e.size
        seg.live += 1
        self._seg_release_locked(old)

    def _remove_locked(self, e: _Entry, *, ghost: bool) -> None:
        self._entries.pop(e.key, None)
        if e.queue == _SMALL:
            # TTL expiry / invalidate / clear can remove an entry still
            # sitting in the probationary queue: its stale token will be
            # skipped later, so the byte count must settle HERE or
            # _small_bytes drifts upward and eviction pressure misroutes
            # onto probation forever (scan resistance degrades to FIFO)
            self._small_bytes -= e.size
            e.queue = -1  # the queue token is now stale
        keys = self._by_fid.get(e.key[0])
        if keys is not None:
            keys.discard(e.key)
            if not keys:
                self._by_fid.pop(e.key[0], None)
        if e.data is not None:
            self._ram_used -= e.size
            e.data = None
        elif e.seg is not None:
            self._seg_live_bytes -= e.size
            self._seg_release_locked(e.seg)
            e.seg = None
        if ghost:
            self._ghost[e.key] = None
            self._ghost_by_fid.setdefault(e.key[0], set()).add(e.key)
            while len(self._ghost) > self._ghost_cap:
                old_key, _ = self._ghost.popitem(last=False)
                self._ghost_fid_discard_locked(old_key)

    def _ghost_fid_discard_locked(self, key: tuple) -> None:
        keys = self._ghost_by_fid.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                self._ghost_by_fid.pop(key[0], None)

    # ---- coherence --------------------------------------------------------

    def link_fids(self, parent_fid: str, child_fids) -> None:
        """Record manifest lineage: invalidating ``parent_fid`` (the
        manifest chunk an event carries) also reclaims the data-chunk
        fids it expanded to — the ranges the cache actually stores."""
        children = {c for c in child_fids if c and c != parent_fid}
        if not children:
            return
        with self._io_lock:
            self._aliases.setdefault(parent_fid, set()).update(children)
            self._aliases.move_to_end(parent_fid)
            while len(self._aliases) > self._ghost_cap:
                self._aliases.popitem(last=False)

    def invalidate_fid(self, fid: str) -> int:
        """Drop every cached range of ``fid`` — and, when it is a known
        manifest chunk, of the data fids it expands to (delete/overwrite
        events from the invalidation planes).  Returns the entry count
        dropped."""
        from seaweedfs_tpu_torch import stats

        fid = fid.strip()
        dropped = 0
        with self._io_lock:
            fids = [fid, *self._aliases.pop(fid, ())]
            for f in fids:
                for key in list(self._by_fid.get(f, ())):
                    e = self._entries.get(key)
                    if e is not None:
                        self._remove_locked(e, ghost=False)
                        dropped += 1
                for key in list(self._ghost_by_fid.pop(f, ())):
                    self._ghost.pop(key, None)
            if dropped:
                self.invalidations += dropped
        if dropped:
            stats.CHUNK_CACHE.inc(dropped, event="invalidate")
        return dropped

    def clear(self) -> None:
        with self._io_lock:
            for e in list(self._entries.values()):
                self._remove_locked(e, ghost=False)
            self._small.clear()
            self._main.clear()
            self._ghost.clear()
            self._ghost_by_fid.clear()
            self._aliases.clear()

    def close(self) -> None:
        with self._io_lock:
            if self._closed:
                return
            self._closed = True
            for e in list(self._entries.values()):
                self._remove_locked(e, ghost=False)
            self._small.clear()
            self._main.clear()
            if self._active is not None and self._active.live <= 0:
                self._segments.pop(self._active.id, None)
                self._active.close()
            self._active = None
            for seg in list(self._segments.values()):
                seg.close()
            self._segments.clear()
            for ev in self._inflight.values():
                ev.set()
            self._inflight.clear()
        _untrack(self)

    # ---- introspection ----------------------------------------------------

    def hit_rate(self) -> float:
        # snapshot once: reading self.hits twice (sum, then numerator)
        # let a concurrent hit land between the reads and push the
        # "rate" past 1.0
        h = self.hits  # racecheck: benign — monotonic counter; stale ratio ok
        m = self.misses  # racecheck: benign — paired with the hits snapshot
        total = h + m
        return h / total if total else 0.0

    def stats(self) -> dict:
        with self._io_lock:
            return {
                "entries": len(self._entries),
                "small_entries": sum(
                    1 for e in self._entries.values() if e.queue == _SMALL
                ),
                "ghost_entries": len(self._ghost),
                "ram_bytes": self._ram_used,
                "segment_files": len(self._segments),
                "segment_bytes": len(self._segments) * self.segment_bytes,
                "capacity_bytes": self.capacity,
                "ram_capacity_bytes": self.ram_capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "hit_bytes": self.hit_bytes,
                "fill_bytes": self.fill_bytes,
                "admits": self.admits,
                "rejects": self.rejects,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "ttl_s": self.ttl,
            }


_MISSING = object()

# ---- process-wide gauge + debug_snapshot registration ----------------------
# ONE sampler per tier, registered once and summing over every live
# instance: per-instance set_function(tier=...) registrations would
# clobber each other in a multi-cache process and one cache's close()
# would delete its siblings' still-live series.

_debug_lock = threading.Lock()
_all_caches: list = []  # weakrefs of every constructed cache
_debug_caches: list = []  # weakrefs: a stopped gateway must not linger
_gauges_registered = False


def _live_caches(refs: list) -> list:
    refs[:] = [r for r in refs if r() is not None]
    return [r() for r in refs if r() is not None]


def _track(cache: ChunkCache) -> None:
    global _gauges_registered
    import weakref

    from seaweedfs_tpu_torch import stats

    with _debug_lock:
        _live_caches(_all_caches)
        _all_caches.append(weakref.ref(cache))
        if not _gauges_registered:
            _gauges_registered = True
            stats.CHUNK_CACHE_BYTES.set_function(
                lambda: sum(c._ram_used for c in _live_caches(_all_caches)),
                tier="ram",
            )
            stats.CHUNK_CACHE_BYTES.set_function(
                lambda: sum(
                    len(c._segments) * c.segment_bytes
                    for c in _live_caches(_all_caches)
                ),
                tier="segment",
            )


def _untrack(cache: ChunkCache) -> None:
    with _debug_lock:
        _all_caches[:] = [
            r for r in _all_caches if r() is not None and r() is not cache
        ]
        _debug_caches[:] = [
            r for r in _debug_caches if r() is not None and r() is not cache
        ]


def register_debug(cache: ChunkCache) -> None:
    import weakref

    with _debug_lock:
        _debug_caches[:] = [r for r in _debug_caches if r() is not None]
        _debug_caches.append(weakref.ref(cache))


def debug_snapshot() -> dict:
    with _debug_lock:
        caches = [r() for r in _debug_caches]
    return {
        "caches": [c.stats() for c in caches if c is not None],
    }
