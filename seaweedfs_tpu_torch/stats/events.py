"""Flight recorder: a bounded per-process ring of structured events.

The port's copy of seaweedfs_tpu/stats/events.py.  Metrics answer "how
much"; traces answer "how was this request served"; neither answers "what
happened at 14:32".  This ring keeps the last WEED_EVENT_RING (default
2048) *notable* events (breaker flips, scrub findings and repairs,
injected faults), each stamped with a wall-clock timestamp and a
per-process sequence number, exposed at /debug/eventz, merged
time-ordered across the cluster by stats/cluster_agg.py, and dumped by
the ``events.dump`` shell command.  The kind vocabulary is the JAX
package's closed set: one event per state transition, never one per
request.
"""

from __future__ import annotations

import collections
import json
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

    def render_text(self, kind: str | None = None, limit: int = 100) -> str:
        rows = self.to_dicts(kind, limit)
        lines = [f"# {len(rows)} events (ring capacity {self.capacity})"]
        for ev in rows:
            stamp = time.strftime("%H:%M:%S", time.localtime(ev["ts"]))
            frac = f"{ev['ts'] % 1:.3f}"[1:]
            attrs = " ".join(f"{k}={v}" for k, v in ev.items() if k not in ("seq", "ts", "kind"))
            lines.append(f"{stamp}{frac} #{ev['seq']:<6d} {ev['kind']:<22s} {attrs}")
        return "\n".join(lines) + "\n"

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


default_ring = EventRing()


def record(kind: str, **attrs) -> None:
    """Record into the process-wide flight recorder."""
    default_ring.record(kind, **attrs)


def merge_timelines(timelines: list[tuple[str, list[dict]]]) -> list[dict]:
    """Fold several members' event lists into one wall-clock-ordered
    timeline, each event tagged with its member address.  Sequence numbers
    only order within a process; across members the shared axis is the
    wall clock."""
    merged = [{**ev, "member": member} for member, events in timelines for ev in events]
    merged.sort(key=lambda e: (e.get("ts", 0.0), e.get("member", ""), e.get("seq", 0)))
    return merged


def debug_body(q: dict) -> tuple[int, bytes]:
    """/debug/eventz: text timeline by default; ?json=1 for machines,
    ?kind= filters, ?limit=N keeps the newest N."""
    kind = q.get("kind", [""])[0] or None
    if kind is not None and kind not in KINDS:
        return 400, f"unknown event kind {kind!r}; kinds: {sorted(KINDS)}\n".encode()
    try:
        limit = int(q.get("limit", ["100"])[0])
    except ValueError:
        limit = 100
    if q.get("json", [""])[0]:
        return 200, json.dumps(default_ring.to_dicts(kind, limit), indent=2).encode()
    return 200, default_ring.render_text(kind, limit).encode()
