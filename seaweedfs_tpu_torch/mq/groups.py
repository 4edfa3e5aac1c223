"""Consumer-group coordination: membership, partition assignment,
rebalance generations, committed offsets.

Counterpart of the reference's weed/mq/sub_coordinator/
(consumer_group.go: ConsumerGroup.Market partition assignment,
OnSubAddConsumerGroupInstance/OnSubRemove* rebalance triggers) and the
offset persistence in weed/mq/offset/.  Redesigned for this MQ's
stateless-ownership model:

  * the coordinator broker for a (topic, group) is derived by
    rendezvous hashing over the live broker set (balancer.py) — no
    coordinator election state to replicate; any broker proxies one
    hop, exactly like Publish;
  * group state (members, generation, assignment) is soft state,
    rebuilt by clients rejoining after a coordinator move — the same
    recovery contract the reference's sub coordinator has when its
    balancer lock moves;
  * committed offsets are DURABLE, stored beside the partition log on
    the partition owner (`offsets.json` in the partition directory), so
    they live and move with the data they index.

Assignment policy: partitions are dealt round-robin over the sorted
member ids (member i of n takes every partition p with p % n == i) —
deterministic, no state, minimal movement when membership changes by
one (the reference's Market does balanced adjustment with an active
assignment map; determinism replaces the map here).

The port's copy of seaweedfs_tpu/mq/groups.py.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _Group:
    __slots__ = ("generation", "members", "partition_count")

    def __init__(self) -> None:
        self.generation = 0
        self.members: dict[str, float] = {}  # instance id -> last heartbeat
        self.partition_count = 0


def assign_partitions(
    members: list[str], partition_count: int
) -> dict[str, list[int]]:
    """Deterministic round-robin deal over sorted member ids."""
    out: dict[str, list[int]] = {m: [] for m in members}
    ordered = sorted(members)
    if not ordered:
        return out
    for p in range(partition_count):
        out[ordered[p % len(ordered)]].append(p)
    return out


class GroupCoordinator:
    """Per-broker group bookkeeping (used for the groups this broker
    coordinates; the routing layer in the servicer sends each group to
    exactly one live broker)."""

    def __init__(self, session_timeout: float = 10.0):
        self.session_timeout = session_timeout
        self._groups: dict[tuple[str, str, str], _Group] = {}
        self._lock = threading.Lock()

    def _expire_locked(self, g: _Group, now: float) -> None:
        dead = [
            m
            for m, hb in g.members.items()
            if now - hb > self.session_timeout
        ]
        for m in dead:
            del g.members[m]
        if dead:
            g.generation += 1

    def join(
        self,
        ns: str,
        topic: str,
        group: str,
        instance: str,
        partition_count: int,
    ) -> tuple[int, list[int]]:
        now = time.monotonic()
        with self._lock:
            g = self._groups.setdefault((ns, topic, group), _Group())
            self._expire_locked(g, now)
            g.partition_count = partition_count
            if instance not in g.members:
                g.generation += 1
            g.members[instance] = now
            parts = assign_partitions(
                list(g.members), g.partition_count
            )[instance]
            return g.generation, parts

    def heartbeat(
        self, ns: str, topic: str, group: str, instance: str, generation: int
    ) -> tuple[bool, int]:
        """Returns (rejoin, current_generation)."""
        now = time.monotonic()
        with self._lock:
            g = self._groups.get((ns, topic, group))
            if g is None or instance not in g.members:
                # unknown member (coordinator moved / session expired):
                # the client must re-join to get an assignment
                return True, g.generation if g else 0
            g.members[instance] = now
            self._expire_locked(g, now)
            return generation != g.generation, g.generation

    def leave(self, ns: str, topic: str, group: str, instance: str) -> None:
        with self._lock:
            g = self._groups.get((ns, topic, group))
            if g is None:
                return
            if g.members.pop(instance, None) is not None:
                g.generation += 1

    def describe(
        self, ns: str, topic: str, group: str
    ) -> tuple[int, dict[str, list[int]]]:
        now = time.monotonic()
        with self._lock:
            g = self._groups.get((ns, topic, group))
            if g is None:
                return 0, {}
            self._expire_locked(g, now)
            return g.generation, assign_partitions(
                list(g.members), g.partition_count
            )


class OffsetStore:
    """Committed offsets for one partition directory: ``offsets.json``
    mapping group -> next offset to consume (Kafka convention).  Written
    atomically; loaded lazily and cached."""

    def __init__(self, dir_path: str):
        self.path = os.path.join(dir_path, "offsets.json")
        self._io_lock = threading.Lock()
        self._cache: dict[str, int] | None = None

    def _load_locked(self) -> dict[str, int]:
        if self._cache is None:
            try:
                with open(self.path) as fh:
                    self._cache = {
                        str(k): int(v) for k, v in json.load(fh).items()
                    }
            except (FileNotFoundError, ValueError):
                self._cache = {}
        return self._cache

    def _save_locked(self, cache: dict[str, int]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(cache, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    def commit(self, group: str, offset: int) -> None:
        with self._io_lock:
            cache = self._load_locked()
            cache[group] = int(offset)
            self._save_locked(cache)

    def fetch(self, group: str) -> int:
        """-1 when the group has no committed offset for this partition."""
        with self._io_lock:
            return self._load_locked().get(group, -1)

    def all(self) -> dict[str, int]:
        """Snapshot of every group's committed offset (replication and
        takeover reconciliation push the whole map)."""
        with self._io_lock:
            return dict(self._load_locked())

    def replace(self, offsets: dict[str, int]) -> None:
        """Mirror offsets pushed by the authoritative side (the partition
        owner on replication, the surviving successor on reconcile).
        Overwrite, don't max-merge: a deliberate backward commit — an
        operator rewinding a group for reprocessing — must survive a
        takeover too."""
        with self._io_lock:
            cache = self._load_locked()
            changed = False
            for group, off in offsets.items():
                if cache.get(group) != int(off):
                    cache[group] = int(off)
                    changed = True
            if changed:
                self._save_locked(cache)
