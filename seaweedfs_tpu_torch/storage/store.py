"""Store: the disk directories of one volume server, the volumes and EC
volumes mounted from them, and the heartbeat view of both.

The port's copy of seaweedfs_tpu/storage/store.py (reference
weed/storage/store.go:57-76, disk_location.go, disk_location_ec.go): load,
create, mount, unmount and destroy volumes; mount, unmount and destroy EC
shards; and the stats plus delta queues (``volume_deltas``,
``ec_shard_deltas``) that the volume server's heartbeat drains.  Every
volume it opens or creates takes the store's fsync policy
(``storage.volume.parse_fsync_policy``) and its storage options, as the
JAX Store's: ``needle_map_kind`` (memory, compact, leveldb),
``backend_kind`` (disk, mmap, memory) and, for new volumes,
``offset_width`` (4 or 5).  The loader opens every ``.dat`` and every
``.vif`` without one whose ``remote`` names a tiered object.  Each disk
directory has a type (``disk_types``, default hdd), the placement
dimension of growth, ``VolumeCopy`` and ``volume.tier.move``.  With the
native data plane on (``dp``, set by the volume server), every volume the
store adds or mounts and every EC volume's local shard set is handed to it.
Not ported: the store-level needle I/O.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from pathlib import Path

from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits
from seaweedfs_tpu_torch.storage.super_block import ttl_to_seconds
from seaweedfs_tpu_torch.storage.volume import (
    NotFoundError,
    Volume,
    parse_fsync_policy,
    volume_file_name,
)
from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info


def _names_remote(vif: Path) -> bool:
    try:
        info = maybe_load_volume_info(vif)
    except (OSError, ValueError):
        return False
    return info is not None and bool(info.remote.get("key"))


class DiskLocation:
    """One disk directory holding volumes and EC shards, of one disk type
    (reference types.DiskType: hdd, ssd, ...)."""

    def __init__(self, directory: str | os.PathLike, max_volume_count: int = 8,
                 fsync: str = "close", disk_type: str = "hdd", needle_map_kind: str = "memory",
                 backend_kind: str = "disk"):
        self.directory = str(directory)
        self.disk_type = disk_type
        self.max_volume_count = max_volume_count
        self.fsync = fsync
        self.needle_map_kind = needle_map_kind
        self.backend_kind = backend_kind
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self.lock = threading.RLock()
        os.makedirs(self.directory, exist_ok=True)

    def load_existing_volumes(self) -> None:
        """Open every volume with a .dat (+.idx) pair in the directory,
        plus the tiered volumes whose .dat lives in an object store (their
        .vif names the object; the .vif of an EC volume names none)."""
        tiered = [p for p in Path(self.directory).glob("*.vif")
                  if not p.with_suffix(".dat").exists() and _names_remote(p)]
        with self.lock:
            for dat in [*Path(self.directory).glob("*.dat"), *tiered]:
                collection, _, vid_part = dat.stem.rpartition("_")
                try:
                    vid = int(vid_part)
                except ValueError:
                    continue
                if vid in self.volumes:
                    continue
                try:
                    vol = Volume(self.directory, vid, collection, create=False,
                                 needle_map_kind=self.needle_map_kind,
                                 backend_kind=self.backend_kind, fsync=self.fsync)
                except (OSError, ValueError):
                    continue
                self.volumes[vid] = vol

    def volume_count(self) -> int:
        with self.lock:
            return len(self.volumes)

    def ec_shard_count(self) -> int:
        with self.lock:
            return sum(len(ev.shards) for ev in self.ec_volumes.values())

    def close(self) -> None:
        with self.lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()


class Store:
    """All disk locations of one volume server + heartbeat delta queues."""

    def __init__(self, directories: list[str | os.PathLike],
                 max_volume_counts: list[int] | None = None, fsync: str = "close",
                 disk_types: list[str] | None = None, needle_map_kind: str = "memory",
                 backend_kind: str = "disk", offset_width: int = 4):
        counts = max_volume_counts or [8] * len(directories)
        types = disk_types or ["hdd"] * len(directories)
        if len(types) == 1 and len(directories) > 1:
            types = types * len(directories)  # one type applies to all dirs
        if len(types) != len(directories) or len(counts) != len(directories):
            # zip would silently drop the unmatched dirs
            raise ValueError(f"{len(directories)} dirs need {len(directories)} disk types/max "
                             f"counts (got {len(types)}/{len(counts)})")
        parse_fsync_policy(fsync)  # refuse a bad policy before any volume opens
        self.fsync = fsync
        self.needle_map_kind = needle_map_kind
        self.backend_kind = backend_kind
        # index offset width of NEW volumes (existing ones keep their
        # superblock's): 4 = 32GB cap, reference-interoperable; 5 = 8TB
        # (the reference's 5BytesOffset build flavor as a store option)
        self.offset_width = offset_width
        self.locations = [DiskLocation(d, c, fsync, t, needle_map_kind, backend_kind)
                          for d, c, t in zip(directories, counts, types)]
        # incremental heartbeat deltas (reference: NewVolumesChan /
        # NewEcShardsChan, store.go:69-74): (kind, volume, disk_type) and
        # (kind, vid, collection, bits, sizes, scheme, disk_type)
        self.volume_deltas: "queue.Queue[tuple[str, Volume, str]]" = queue.Queue()
        self.ec_shard_deltas: (
            "queue.Queue[tuple[str, int, str, ShardBits, list[int], EcScheme, str]]"
        ) = queue.Queue()
        # the native HTTP data plane (native/dataplane.py), set by the
        # volume server while its native front door is up: volumes added or
        # mounted from then on register with it
        self.dp = None

    def load_existing_volumes(self) -> None:
        for loc in self.locations:
            loc.load_existing_volumes()

    def close(self) -> None:
        for loc in self.locations:
            loc.close()

    # -- normal volumes ----------------------------------------------------

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def find_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            with loc.lock:
                if vid in loc.volumes:
                    return loc.volumes[vid]
        return None

    def _location_with_room(self, disk_type: str = "") -> DiskLocation | None:
        want = disk_type or "hdd"
        best, free = None, 0
        for loc in self.locations:
            if loc.disk_type != want:
                continue
            room = loc.max_volume_count - loc.volume_count()
            if room > free:
                best, free = loc, room
        return best

    def add_volume(self, vid: int, collection: str = "", replica_placement: str = "000",
                   ttl_seconds: int = 0, disk_type: str = "") -> Volume:
        if self.has_volume(vid):
            raise ValueError(f"volume {vid} already exists")
        loc = self._location_with_room(disk_type)
        if loc is None:
            raise ValueError(f"no {disk_type or 'hdd'} disk location has room for a new volume")
        vol = Volume(loc.directory, vid, collection, replica_placement, ttl_seconds=ttl_seconds,
                     needle_map_kind=self.needle_map_kind, backend_kind=self.backend_kind,
                     offset_width=self.offset_width, fsync=self.fsync)
        with loc.lock:
            loc.volumes[vid] = vol
        if self.dp is not None:
            self.dp.register_volume(vol)
        self.volume_deltas.put(("new", vol, loc.disk_type))
        return vol

    def mount_volume(self, vid: int, collection: str = "") -> Volume:
        """Open an on-disk .dat/.idx pair as a live volume (the decode path:
        reference VolumeEcShardsToVolume leaves the files for a subsequent
        VolumeMount, volume_grpc_admin.go)."""
        if self.has_volume(vid):
            raise ValueError(f"volume {vid} already mounted")
        for loc in self.locations:
            if not os.path.exists(volume_file_name(loc.directory, collection, vid) + ".dat"):
                continue
            vol = Volume(loc.directory, vid, collection, create=False,
                         needle_map_kind=self.needle_map_kind, backend_kind=self.backend_kind,
                         fsync=self.fsync)
            with loc.lock:
                loc.volumes[vid] = vol
            if self.dp is not None:
                self.dp.register_volume(vol)
            self.volume_deltas.put(("new", vol, loc.disk_type))
            return vol
        raise NotFoundError(f"no .dat for volume {vid} on any disk location")

    def unmount_volume(self, vid: int) -> None:
        """Forget a volume without destroying its files."""
        for loc in self.locations:
            with loc.lock:
                vol = loc.volumes.pop(vid, None)
            if vol is not None:
                vol.close()
                self.volume_deltas.put(("deleted", vol, loc.disk_type))
                return
        raise NotFoundError(f"volume {vid} not found")

    def delete_volume(self, vid: int, only_empty: bool = False) -> None:
        for loc in self.locations:
            with loc.lock:
                vol = loc.volumes.get(vid)
                if vol is None:
                    continue
                if only_empty and vol.file_count() > 0:
                    raise ValueError(f"volume {vid} not empty")
                del loc.volumes[vid]
            self.volume_deltas.put(("deleted", vol, loc.disk_type))
            vol.destroy()
            return
        raise NotFoundError(f"volume {vid} not found")

    # -- EC volumes --------------------------------------------------------

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            with loc.lock:
                if vid in loc.ec_volumes:
                    return loc.ec_volumes[vid]
        return None

    def _ec_location_for(self, collection: str, vid: int) -> DiskLocation | None:
        """Disk that already has shard/index files for this EC volume."""
        for loc in self.locations:
            if os.path.exists(volume_file_name(loc.directory, collection, vid) + ".ecx"):
                return loc
        return None

    def mount_ec_shards(self, collection: str, vid: int, shard_ids: list[int]) -> None:
        """Open the EC volume (if needed) and register local shard files;
        the newly mounted ones go out as a heartbeat delta (reference
        Store.MountEcShards, store_ec.go:25-49)."""
        ev = self.find_ec_volume(vid)
        if ev is None:
            loc = self._ec_location_for(collection, vid)
            if loc is None:
                raise NotFoundError(f"no .ecx for EC volume {vid} on any disk")
            # scheme=None: EcVolume reads the geometry and storage class
            # from the .vif, so non-default volumes mount correctly
            ev = EcVolume(loc.directory, vid, collection, scheme=None)
            with loc.lock:
                loc.ec_volumes[vid] = ev
        added = [sid for sid in shard_ids if ev.add_shard(sid)]
        # the native plane serves this EC volume's local-shard reads
        if self.dp is not None:
            if getattr(ev, "_dp", None) is None:
                self.dp.register_ec_volume(ev)
            else:
                self.dp.sync_ec_shards(ev)
        if added:
            bits = ShardBits(0)
            for sid in added:
                bits = bits.add(sid)
            sizes = [ev.shards[sid].size() for sid in sorted(added)]
            self.ec_shard_deltas.put(("new", vid, collection, bits, sizes, ev.scheme,
                                      self.ec_disk_type_of(vid)))

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        ev = self.find_ec_volume(vid)
        if ev is None:
            return
        removed = [sid for sid in shard_ids if ev.delete_shard(sid) is not None]
        if removed and self.dp is not None and getattr(ev, "_dp", None):
            self.dp.sync_ec_shards(ev)
        if removed:
            bits = ShardBits(0)
            for sid in removed:
                bits = bits.add(sid)
            self.ec_shard_deltas.put(("deleted", vid, ev.collection, bits, [], ev.scheme,
                                      self.ec_disk_type_of(vid)))
        if not ev.shards:
            if self.dp is not None and getattr(ev, "_dp", None):
                self.dp.unregister_ec_volume(ev)
            for loc in self.locations:
                with loc.lock:
                    if loc.ec_volumes.get(vid) is ev:
                        del loc.ec_volumes[vid]
            ev.close()

    def destroy_ec_shards(self, collection: str, vid: int, shard_ids: list[int]) -> None:
        """Unmount and delete local shard files (+ index files when the last
        shard goes away): reference VolumeEcShardsDelete semantics."""
        if self.find_ec_volume(vid) is not None:
            self.unmount_ec_shards(vid, shard_ids)
        for loc in self.locations:
            base = volume_file_name(loc.directory, collection, vid)
            for sid in shard_ids:
                p = base + f".ec{sid:02d}"
                if os.path.exists(p):
                    os.remove(p)
            # geometry-independent probe for any remaining shard files
            if not glob.glob(glob.escape(base) + ".ec[0-9][0-9]"):
                for ext in (".ecx", ".ecj", ".vif"):
                    if os.path.exists(base + ext):
                        os.remove(base + ext)

    # -- heartbeat assembly ------------------------------------------------

    def volume_stats(self) -> list[dict]:
        out = []
        for loc in self.locations:
            with loc.lock:
                for vol in loc.volumes.values():
                    out.append({
                        "id": vol.id,
                        "collection": vol.collection,
                        "size": vol.dat_size(),
                        "file_count": vol.file_count(),
                        "deleted_bytes": vol.deleted_bytes(),
                        "read_only": vol.read_only,
                        "replica_placement": str(vol.super_block.replica_placement),
                        "version": int(vol.version),
                        "ttl_seconds": ttl_to_seconds(vol.super_block.ttl),
                        "disk_type": loc.disk_type,
                        "last_scrub_ns": vol.last_scrub_at_ns,
                        "scrub_corrupt": vol.scrub_corrupt,
                    })
        return out

    def ec_shard_stats(self) -> list[dict]:
        out = []
        for loc in self.locations:
            with loc.lock:
                for ev in loc.ec_volumes.values():
                    bits = ShardBits(0)
                    for sid in ev.shard_ids():
                        bits = bits.add(sid)
                    out.append({
                        "volume_id": ev.vid,
                        "collection": ev.collection,
                        "shard_bits": int(bits),
                        "shard_sizes": [ev.shards[sid].size() for sid in ev.shard_ids()],
                        "data_shards": ev.scheme.data_shards,
                        "parity_shards": ev.scheme.parity_shards,
                        "local_groups": getattr(ev.scheme, "local_groups", 0),
                        "disk_type": loc.disk_type,
                    })
        return out

    def max_volume_count(self) -> int:
        return sum(loc.max_volume_count for loc in self.locations)

    def max_volume_counts_by_type(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for loc in self.locations:
            out[loc.disk_type] = out.get(loc.disk_type, 0) + loc.max_volume_count
        return out

    def disk_type_of(self, vid: int) -> str:
        for loc in self.locations:
            if vid in loc.volumes:
                return loc.disk_type
        return "hdd"

    def ec_disk_type_of(self, vid: int) -> str:
        for loc in self.locations:
            if vid in loc.ec_volumes:
                return loc.disk_type
        return "hdd"
