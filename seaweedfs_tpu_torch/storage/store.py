"""Store: the disk directories of one volume server and the EC volumes
mounted from them.

The EC half of seaweedfs_tpu/storage/store.py (reference
weed/storage/store.go, disk_location_ec.go): find, mount, unmount and
destroy EC shards across a server's disks.  Normal volumes, needle writes,
the native data plane and the heartbeat delta queues are not ported.
"""

from __future__ import annotations

import glob
import os
import threading

from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import EcVolume
from seaweedfs_tpu_torch.storage.volume import NotFoundError, volume_file_name


class DiskLocation:
    """One disk directory holding EC shards."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = str(directory)
        self.ec_volumes: dict[int, EcVolume] = {}
        self.lock = threading.RLock()
        os.makedirs(self.directory, exist_ok=True)

    def close(self) -> None:
        with self.lock:
            for ev in self.ec_volumes.values():
                ev.close()
            self.ec_volumes.clear()


class Store:
    """All disk locations of one volume server."""

    def __init__(self, directories: list[str | os.PathLike]):
        self.locations = [DiskLocation(d) for d in directories]

    def close(self) -> None:
        for loc in self.locations:
            loc.close()

    def find_ec_volume(self, vid: int) -> EcVolume | None:
        for loc in self.locations:
            with loc.lock:
                if vid in loc.ec_volumes:
                    return loc.ec_volumes[vid]
        return None

    def _ec_location_for(self, collection: str, vid: int) -> DiskLocation | None:
        """Disk that already has shard/index files for this EC volume."""
        for loc in self.locations:
            base = volume_file_name(loc.directory, collection, vid)
            if os.path.exists(base + ".ecx"):
                return loc
        return None

    def mount_ec_shards(self, collection: str, vid: int, shard_ids: list[int]) -> None:
        """Open the EC volume (if needed) and register local shard files
        (reference Store.MountEcShards, store_ec.go:25-49)."""
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
        for sid in shard_ids:
            ev.add_shard(sid)

    def unmount_ec_shards(self, vid: int, shard_ids: list[int]) -> None:
        ev = self.find_ec_volume(vid)
        if ev is None:
            return
        for sid in shard_ids:
            ev.delete_shard(sid)
        if not ev.shards:
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
