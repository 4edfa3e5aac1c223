"""Flight recorder: a bounded per-process ring of structured events.

The port's copy of seaweedfs_tpu/stats/events.py.  Metrics answer "how
much"; this ring keeps the last WEED_EVENT_RING (default 2048) *notable*
events (scrub findings and repairs, in the port so far), each stamped with
a wall-clock timestamp and a per-process sequence number.  The kind
vocabulary is the JAX package's closed set: one event per state
transition, never one per request.  ``to_dicts`` reads it; the text
rendering, the cluster merge, ``/debug/eventz`` and the ``events.dump``
shell command are not ported.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from seaweedfs_tpu_torch import stats

BREAKER_OPEN = "breaker.open"
BREAKER_CLOSE = "breaker.close"
BREAKER_HALF_OPEN = "breaker.half_open"
SHARD_UNAVAILABLE = "shard.unavailable"
SCRUB_CORRUPTION = "scrub.corruption"
SCRUB_REPAIRED = "scrub.repaired"
FAULT_INJECTED = "fault.injected"
CACHE_SEGMENT_RECLAIM = "cache.segment_reclaim"
LEADER_CHANGE = "leader.change"

KINDS = frozenset({
    BREAKER_OPEN,
    BREAKER_CLOSE,
    BREAKER_HALF_OPEN,
    SHARD_UNAVAILABLE,
    SCRUB_CORRUPTION,
    SCRUB_REPAIRED,
    FAULT_INJECTED,
    CACHE_SEGMENT_RECLAIM,
    LEADER_CHANGE,
})


class EventRing:
    """Newest-kept bounded ring.  ``record`` is cheap enough to call from
    under other locks: one deque append under a private lock, no I/O."""

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            capacity = int(os.environ.get("WEED_EVENT_RING", "2048"))
        self.capacity = max(16, capacity)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, kind: str, **attrs) -> None:
        if kind not in KINDS:
            raise ValueError(f"unregistered event kind {kind!r}")
        if not attrs.keys().isdisjoint(("seq", "ts", "kind", "member")):
            raise ValueError("attrs may not shadow seq/ts/kind/member")
        ts = time.time()  # wall clock: events are read by humans at "14:32"
        with self._lock:
            self._seq += 1
            if len(self._ring) == self.capacity:
                stats.EVENTS_DROPPED.inc()
            self._ring.append((self._seq, ts, kind, attrs))

    def to_dicts(self, kind: str | None = None, limit: int = 0) -> list[dict]:
        """Oldest-first event dicts; ``kind`` filters, ``limit`` keeps the
        newest N after filtering (0 = all)."""
        with self._lock:
            items = list(self._ring)
        out = [{"seq": seq, "ts": ts, "kind": k, **attrs}
               for seq, ts, k, attrs in items if kind is None or k == kind]
        if limit > 0:
            out = out[-limit:]
        return out


default_ring = EventRing()


def record(kind: str, **attrs) -> None:
    """Record into the process-wide flight recorder."""
    default_ring.record(kind, **attrs)
