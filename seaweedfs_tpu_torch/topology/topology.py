"""In-memory cluster topology kept by the master.

The port's copy of seaweedfs_tpu/topology/topology.py (reference
weed/topology/topology.go:30-61, data_node.go, topology_ec.go:16-42,
volume_layout.go, volume_growth.go, capacity reservation in node.go): a
DC -> rack -> data-node tree fed by streaming heartbeats (full state, then
deltas), per-(collection, replication, ttl, disk type) volume layouts, the
master-side EC shard map (vid -> shard -> nodes) with each EC volume's
storage class, dead-node pruning, the lookups, and the write half: file
keys and volume ids, assign (``pick_for_write``) and rack-aware volume
growth with capacity reservations.  The sequence's persistence and HA
watermark adoption (``restore_sequence``, the persist hook) belong to
master HA and are not ported: one master's ids start from the clock.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits


@dataclass
class VolumeRecord:
    id: int
    collection: str = ""
    size: int = 0
    file_count: int = 0
    deleted_bytes: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    version: int = 3
    ttl_seconds: int = 0
    disk_type: str = "hdd"
    # scrub health (heartbeat VolumeStat 12/13)
    last_scrub_ns: int = 0
    scrub_corrupt: int = 0
    last_modified: float = field(default_factory=time.time)


class DataNode:
    def __init__(
        self,
        node_id: str,
        ip: str,
        port: int,
        grpc_port: int,
        public_url: str = "",
        data_center: str = "DefaultDataCenter",
        rack: str = "DefaultRack",
        max_volume_count: int = 8,
    ):
        self.id = node_id
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port
        self.public_url = public_url or f"{ip}:{port}"
        self.data_center = data_center
        self.rack = rack
        self.max_volume_count = max_volume_count
        # per-disk-type capacity (reference types.DiskType; "" == hdd)
        self.max_volume_counts: dict[str, int] = {"hdd": max_volume_count}
        self.volumes: dict[int, VolumeRecord] = {}
        self.ec_shards: dict[int, ShardBits] = {}
        self.ec_collections: dict[int, str] = {}
        self.ec_disk_types: dict[int, str] = {}  # vid -> shard disk type
        self.reserved = 0  # in-flight volume growth reservations (all types)
        self.reserved_by_type: dict[str, int] = {}
        self.last_seen = time.monotonic()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def free_slots(self, disk_type: str = "") -> int:
        # EC shards consume fractional slots (k+m shards ~= 1 volume);
        # they are attributed to hdd
        ec_load = -(-sum(b.count() for b in self.ec_shards.values()) // 14)
        if not disk_type:
            return (sum(self.max_volume_counts.values()) - len(self.volumes) - self.reserved
                    - ec_load)
        used = sum(1 for r in self.volumes.values() if r.disk_type == disk_type)
        out = (self.max_volume_counts.get(disk_type, 0) - used
               - self.reserved_by_type.get(disk_type, 0))
        if disk_type == "hdd":
            out -= ec_load
        return out

    def ec_shard_count(self) -> int:
        return sum(b.count() for b in self.ec_shards.values())


class VolumeLayout:
    """Writable/readonly volume lists for one (collection, replication)."""

    def __init__(self, replica_placement: str, volume_size_limit: int):
        self.replica_placement = replica_placement
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, set[str]] = {}  # vid -> node ids
        self.writable: set[int] = set()
        self.readonly: set[int] = set()

    def register(self, rec: VolumeRecord, node: DataNode) -> None:
        self.locations.setdefault(rec.id, set()).add(node.id)
        if rec.read_only or rec.size >= self.volume_size_limit:
            self.readonly.add(rec.id)
            self.writable.discard(rec.id)
        elif rec.id not in self.readonly:
            # a volume is writable only while every replica is writable
            self.writable.add(rec.id)

    def unregister(self, vid: int, node_id: str) -> None:
        nodes = self.locations.get(vid)
        if nodes is None:
            return
        nodes.discard(node_id)
        if not nodes:
            del self.locations[vid]
            self.writable.discard(vid)
            self.readonly.discard(vid)

    def pick_writable(self) -> int | None:
        if not self.writable:
            return None
        return random.choice(tuple(self.writable))


class Topology:
    """Cluster state + assign/lookup/grow operations."""

    def __init__(self, volume_size_limit: int = 30 * 1024**3):
        self.lock = threading.RLock()
        self.nodes: dict[str, DataNode] = {}
        # keyed by (collection, replication, ttl, disk_type)
        self.layouts: dict[tuple[str, str, int, str], VolumeLayout] = {}
        # vid -> shard_id -> set of node ids (reference ecShardMap,
        # topology.go:35 / topology_ec.go)
        self.ec_shard_map: dict[int, dict[int, set[str]]] = {}
        self.ec_collections: dict[int, str] = {}
        # vid -> (data_shards, parity_shards, local_groups); (0, 0, 0)
        # until a holder reports; local_groups > 0 marks the LRC class
        self.ec_schemes: dict[int, tuple[int, int, int]] = {}
        self.volume_size_limit = volume_size_limit
        self.max_volume_id = 0
        self._file_key = int(time.time()) << 20  # coarse snowflake epoch base
        self.dead_node_timeout = 15.0
        # per-layout growth serialization (see pick_for_write); guarded by
        # the GIL for setdefault, entries live for the process lifetime
        self._growth_locks: dict[tuple, threading.Lock] = {}

    # -- sequence ----------------------------------------------------------

    def next_file_key(self, count: int = 1) -> int:
        with self.lock:
            self._file_key += count
            return self._file_key

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    # -- heartbeat sync ----------------------------------------------------

    def _layout(self, collection: str, replication: str, ttl: int,
                disk_type: str = "hdd") -> VolumeLayout:
        key = (collection, replication, ttl, disk_type or "hdd")
        if key not in self.layouts:
            self.layouts[key] = VolumeLayout(replication, self.volume_size_limit)
        return self.layouts[key]

    def register_node(self, node: DataNode) -> DataNode:
        with self.lock:
            existing = self.nodes.get(node.id)
            if existing is None:
                self.nodes[node.id] = node
                existing = node
            else:
                # a restarted server may come back with a new grpc port /
                # placement: refresh the endpoint facts
                existing.grpc_port = node.grpc_port
                existing.public_url = node.public_url
                existing.data_center = node.data_center
                existing.rack = node.rack
                existing.max_volume_count = node.max_volume_count
            existing.last_seen = time.monotonic()
            return existing

    def prune_dead_nodes(self) -> list[str]:
        """Drop nodes that missed heartbeats past the timeout, unregistering
        their volumes and EC shards; returns the pruned node ids."""
        now = time.monotonic()
        with self.lock:
            dead = [nid for nid, n in self.nodes.items()
                    if now - n.last_seen > self.dead_node_timeout]
        for nid in dead:
            self.remove_node(nid)
        return dead

    def remove_node(self, node_id: str) -> None:
        with self.lock:
            node = self.nodes.pop(node_id, None)
            if node is None:
                return
            for rec in list(node.volumes.values()):
                self._unregister_volume_locked(rec, node)
            for vid in list(node.ec_shards):
                self._unregister_ec_shards_locked(vid, node, node.ec_shards[vid])

    def sync_full_volumes(self, node: DataNode, records: list[VolumeRecord]) -> None:
        with self.lock:
            for rec in list(node.volumes.values()):
                self._unregister_volume_locked(rec, node)
            node.volumes.clear()
            for rec in records:
                self._register_volume_locked(rec, node)

    def apply_volume_deltas(self, node: DataNode, new: list[VolumeRecord],
                            deleted: list[VolumeRecord]) -> None:
        with self.lock:
            for rec in new:
                self._register_volume_locked(rec, node)
            for rec in deleted:
                self._unregister_volume_locked(rec, node)

    def _register_volume_locked(self, rec: VolumeRecord, node: DataNode) -> None:
        old = node.volumes.get(rec.id)
        if old is not None and (
            old.collection, old.replica_placement, old.ttl_seconds, old.disk_type
        ) != (rec.collection, rec.replica_placement, rec.ttl_seconds, rec.disk_type):
            # the volume changed layouts: drop the stale entry
            self._layout(old.collection, old.replica_placement, old.ttl_seconds,
                         old.disk_type).unregister(old.id, node.id)
        node.volumes[rec.id] = rec
        self.max_volume_id = max(self.max_volume_id, rec.id)
        self._layout(rec.collection, rec.replica_placement, rec.ttl_seconds,
                     rec.disk_type).register(rec, node)

    def _unregister_volume_locked(self, rec: VolumeRecord, node: DataNode) -> None:
        # key the layout off the REGISTERED record when there is one: a
        # delta whose stats disagree must still evict from the layout the
        # volume actually lives in
        stored = node.volumes.pop(rec.id, None) or rec
        self._layout(stored.collection, stored.replica_placement, stored.ttl_seconds,
                     stored.disk_type).unregister(rec.id, node.id)

    def sync_full_ec_shards(self, node: DataNode, entries: list[tuple]) -> None:
        """Reference: Topology.SyncDataNodeEcShards (topology_ec.go:16-42).
        Entries: (vid, collection, bits, k, m, local_groups[, disk_type])."""
        with self.lock:
            for vid in list(node.ec_shards):
                self._unregister_ec_shards_locked(vid, node, node.ec_shards[vid])
            node.ec_shards.clear()
            node.ec_disk_types.clear()
            for vid, collection, bits, k, m, lg, *dt in entries:
                self._register_ec_shards_locked(vid, collection, node, bits, k, m, lg,
                                                dt[0] if dt else "hdd")

    def apply_ec_deltas(self, node: DataNode, new: list[tuple], deleted: list[tuple]) -> None:
        with self.lock:
            for vid, collection, bits, k, m, lg, *dt in new:
                self._register_ec_shards_locked(vid, collection, node, bits, k, m, lg,
                                                dt[0] if dt else "hdd")
            for vid, _collection, bits, _k, _m, _lg, *_dt in deleted:
                self._unregister_ec_shards_locked(vid, node, bits)

    def _register_ec_shards_locked(
        self,
        vid: int,
        collection: str,
        node: DataNode,
        bits: ShardBits,
        data_shards: int = 0,
        parity_shards: int = 0,
        local_groups: int = 0,
        disk_type: str = "hdd",
    ) -> None:
        node.ec_shards[vid] = ShardBits(node.ec_shards.get(vid, ShardBits(0)) | bits)
        node.ec_collections[vid] = collection
        node.ec_disk_types[vid] = disk_type or "hdd"
        self.ec_collections[vid] = collection
        if data_shards:
            self.ec_schemes[vid] = (data_shards, parity_shards, local_groups)
        shard_map = self.ec_shard_map.setdefault(vid, {})
        for sid in bits.ids():
            shard_map.setdefault(sid, set()).add(node.id)
        self.max_volume_id = max(self.max_volume_id, vid)

    def _unregister_ec_shards_locked(self, vid: int, node: DataNode, bits: ShardBits) -> None:
        have = node.ec_shards.get(vid, ShardBits(0)).minus(bits)
        if have.count():
            node.ec_shards[vid] = have
        else:
            node.ec_shards.pop(vid, None)
            node.ec_collections.pop(vid, None)
            node.ec_disk_types.pop(vid, None)
        shard_map = self.ec_shard_map.get(vid)
        if not shard_map:
            return
        for sid in bits.ids():
            nodes = shard_map.get(sid)
            if nodes:
                nodes.discard(node.id)
                if not nodes:
                    del shard_map[sid]
        if not shard_map:
            del self.ec_shard_map[vid]
            self.ec_collections.pop(vid, None)
            self.ec_schemes.pop(vid, None)

    # -- lookup ------------------------------------------------------------

    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        with self.lock:
            return [node for node in self.nodes.values() if vid in node.volumes]

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        """Reference: LookupEcShards (topology_ec.go:147-154)."""
        with self.lock:
            shard_map = self.ec_shard_map.get(vid, {})
            return {sid: [self.nodes[n] for n in nodes if n in self.nodes]
                    for sid, nodes in shard_map.items()}

    # -- assign / growth ---------------------------------------------------

    def pick_for_write(self, count: int, collection: str, replication: str, ttl: int,
                       disk_type: str = "", growth_count: int = 1) -> tuple[str, list[DataNode]]:
        """Returns (fid, [primary + replica nodes]); grows volumes when no
        writable volume exists for the layout, ``growth_count`` of them at
        once."""
        disk_type = disk_type or "hdd"
        with self.lock:
            layout = self._layout(collection, replication, ttl, disk_type)
            vid = layout.pick_writable()
        if vid is None:
            # serialize growth per layout (the reference's single-grower
            # volumeGrowthRequestChan): under an assign burst on an empty
            # layout, one caller grows while the rest wait and reuse the
            # fresh volume; without this, N concurrent assigns race into N
            # growths and the losers fail with "no free slots"
            grow_lock = self._growth_locks.setdefault(
                (collection, replication, ttl, disk_type), threading.Lock())
            with grow_lock:
                with self.lock:
                    vid = layout.pick_writable()
                if vid is None:
                    # growth issues blocking gRPC allocates: outside the
                    # topology lock
                    vid = self.grow_volumes(collection, replication, ttl,
                                            count=max(1, growth_count), disk_type=disk_type)
        with self.lock:
            # the fid names the FIRST key of the reserved span; clients
            # derive the rest as fid_1..fid_{count-1} (key+i, same cookie),
            # the reference's batch-assign convention
            start_key = self.next_file_key(count) - count + 1
            cookie = random.getrandbits(32)
            nodes = [self.nodes[n] for n in layout.locations.get(vid, ()) if n in self.nodes]
            if not nodes:
                raise RuntimeError(f"no locations for assigned volume {vid}")
            return f"{vid},{start_key:x}{cookie:08x}", nodes

    def grow_volumes(self, collection: str, replication: str, ttl: int, count: int = 1,
                     disk_type: str = "") -> int:
        """Allocate new volumes on placement-satisfying nodes; returns the
        last vid.  Reference volume_growth.go findEmptySlotsForOneVolume:
        main + replica nodes honoring the xyz placement code, with a
        capacity reservation held while the gRPC allocates run, so
        concurrent assigns cannot oversubscribe a node."""
        from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement

        rp = ReplicaPlacement.parse(replication or "000")
        disk_type = disk_type or "hdd"
        vid = None
        for _ in range(count):
            with self.lock:
                chosen = self._choose_nodes(rp, disk_type)
                for n in chosen:
                    n.reserved += 1
                    n.reserved_by_type[disk_type] = n.reserved_by_type.get(disk_type, 0) + 1
                new_vid = self.next_volume_id()
            try:
                self._allocate_on(chosen, new_vid, collection, replication, ttl, disk_type)
                # register now: the heartbeat delta confirms later, but
                # assigns must see the new locations at once
                with self.lock:
                    for n in chosen:
                        self._register_volume_locked(
                            VolumeRecord(id=new_vid, collection=collection,
                                         replica_placement=replication or "000",
                                         ttl_seconds=ttl, disk_type=disk_type), n)
            finally:
                with self.lock:
                    for n in chosen:
                        n.reserved -= 1
                        n.reserved_by_type[disk_type] = max(
                            0, n.reserved_by_type.get(disk_type, 0) - 1)
            vid = new_vid
        return vid

    def _choose_nodes(self, rp, disk_type: str = "hdd") -> list[DataNode]:
        """Pick 1 + z same-rack + y other-rack + x other-DC nodes with room.
        Every candidate is tried as the main node (most-free first) until
        one satisfies the placement: a main in a single-node rack must not
        doom a same-rack-replica request another rack could serve."""
        candidates = [n for n in self.nodes.values() if n.free_slots(disk_type) > 0]
        if not candidates:
            raise RuntimeError(f"no free {disk_type} slots in cluster")
        random.shuffle(candidates)
        candidates.sort(key=lambda n: -n.free_slots(disk_type))
        last_err: Exception | None = None
        for main in candidates:
            try:
                return self._nodes_around(main, candidates, rp, disk_type)
            except RuntimeError as e:
                last_err = e
        raise RuntimeError(f"placement unsatisfiable: {last_err}")

    @staticmethod
    def _nodes_around(main, candidates, rp, disk_type="hdd") -> list[DataNode]:
        chosen = [main]

        def take(pool, want):
            got = []
            for n in pool:
                if len(got) >= want:
                    break
                if n not in chosen and n.free_slots(disk_type) > 0:
                    got.append(n)
            if len(got) < want:
                raise RuntimeError(f"wanted {want} more nodes near {main.id}")
            return got

        same_rack = [n for n in candidates if n.rack == main.rack
                     and n.data_center == main.data_center and n is not main]
        other_rack = [n for n in candidates
                      if n.data_center == main.data_center and n.rack != main.rack]
        other_dc = [n for n in candidates if n.data_center != main.data_center]
        chosen += take(same_rack, rp.same_rack)
        chosen += take(other_rack, rp.diff_rack)
        chosen += take(other_dc, rp.diff_dc)
        return chosen

    def _allocate_on(self, nodes: list[DataNode], vid: int, collection: str, replication: str,
                     ttl: int, disk_type: str = "") -> None:
        """Issue AllocateVolume to each chosen volume server (overridable
        for in-memory tests)."""
        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb

        for node in nodes:
            rpc.volume_stub(node.grpc_address).AllocateVolume(vs_pb.AllocateVolumeRequest(
                volume_id=vid, collection=collection, replication=replication,
                ttl_seconds=ttl, disk_type=disk_type))

    # -- views -------------------------------------------------------------

    def alive_nodes(self) -> list[DataNode]:
        now = time.monotonic()
        with self.lock:
            return [n for n in self.nodes.values() if now - n.last_seen < self.dead_node_timeout]

    def collections(self) -> set[str]:
        with self.lock:
            names = {rec.collection for node in self.nodes.values()
                     for rec in node.volumes.values()}
            names |= set(self.ec_collections.values())
            return names
