"""Runtime EC volume: serve needle reads from mounted shard files (the
port's copy of seaweedfs_tpu/storage/erasure_coding/ec_volume.py).

Behavioral counterpart of weed/storage/erasure_coding/ec_volume.go /
ec_shard.go / ec_volume_delete.go: binary search of the sorted .ecx for
needle locations, interval math over mounted .ecNN shards, tombstoning via
.ecj journal + in-place .ecx size overwrite, and journal replay
(``rebuild_ecx_file``).  Shards may be locally mounted files; reads of
missing intervals go through a pluggable fetcher (the volume server wires
in server/store_ec.EcShardLocator's reconstruction).  Host only, as in the
JAX package: a needle read runs no kernel.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from seaweedfs_tpu_torch.storage.erasure_coding.ec_locate import Interval, locate_data
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from seaweedfs_tpu_torch.storage.types import (
    NEEDLE_ID_SIZE,
    TOMBSTONE_FILE_SIZE,
    Version,
    get_actual_size,
    index_entry_size,
    size_is_deleted,
    unpack_index_entry,
)
from seaweedfs_tpu_torch.storage.volume import NotFoundError, volume_file_name
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, maybe_load_volume_info


def ec_shard_file_name(
    collection: str, directory: str | os.PathLike, vid: int
) -> str:
    return volume_file_name(directory, collection, vid)


def ec_offset_width(base_file_name: str, info: VolumeInfo | None = None) -> int:
    """Index offset width of an EC volume: the .vif records it at generate
    time; an older .vif falls back to the source superblock at the head of
    a locally-present first shard (the superblock is the first 8 bytes of
    the .dat, hence of .ec00); 4 otherwise."""
    if info is None:
        info = maybe_load_volume_info(base_file_name + ".vif")
    if info is not None and info.offset_width:
        return info.offset_width
    try:
        with open(base_file_name + ".ec00", "rb") as f:
            return SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE)).offset_width
    except (OSError, ValueError):
        return 4


@dataclass
class EcVolumeShard:
    vid: int
    shard_id: int
    path: str

    def __post_init__(self):
        self._f = open(self.path, "rb")

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def read_at(self, offset: int, length: int) -> bytes:
        return os.pread(self._f.fileno(), length, offset)

    def close(self) -> None:
        self._f.close()


class EcVolume:
    """Mounted EC volume: .ecx index + any locally present shards."""

    def __init__(
        self,
        directory: str | os.PathLike,
        vid: int,
        collection: str = "",
        scheme: EcScheme | None = DEFAULT_SCHEME,
    ):
        self.vid = vid
        self.collection = collection
        self.base = ec_shard_file_name(collection, directory, vid)
        # the .ecx IS this class's contract: the only mutation is the
        # 4-byte in-place tombstone pwrite (atomic at sector granularity),
        # journaled through .ecj replay for crashes
        self._ecx = open(self.base + ".ecx", "r+b")
        self.ecx_size = os.fstat(self._ecx.fileno()).st_size
        # append-only tombstone journal; replay (rebuild_ecx_file)
        # tolerates a torn tail by construction
        self._ecj = open(self.base + ".ecj", "a+b")
        self._ecj_lock = threading.Lock()
        self.shards: dict[int, EcVolumeShard] = {}
        info = maybe_load_volume_info(self.base + ".vif")
        if scheme is None:
            # derive the storage class + geometry from .vif (written at
            # generate time) so a plain mount opens non-default RS — and
            # LRC — volumes correctly
            if info and info.data_shards and info.parity_shards:
                from seaweedfs_tpu_torch.storage.erasure_coding.lrc import make_scheme

                scheme = make_scheme(
                    info.data_shards,
                    info.parity_shards,
                    info.local_groups,
                )
            else:
                scheme = DEFAULT_SCHEME
        self.scheme = scheme
        self.version = Version(info.version) if info else Version.V3
        self.dat_file_size = info.dat_file_size if info else 0
        self.offset_width = ec_offset_width(self.base, info)
        self.entry_size = index_entry_size(self.offset_width)

    # -- shard management --------------------------------------------------

    def add_shard(self, shard_id: int) -> bool:
        if shard_id in self.shards:
            return False
        path = self.base + self.scheme.shard_ext(shard_id)
        self.shards[shard_id] = EcVolumeShard(self.vid, shard_id, path)
        return True

    def delete_shard(self, shard_id: int) -> EcVolumeShard | None:
        shard = self.shards.pop(shard_id, None)
        if shard:
            shard.close()
        return shard

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.size()
        return 0

    def close(self) -> None:
        for s in self.shards.values():
            s.close()
        self.shards.clear()
        self._ecx.close()
        self._ecj.close()

    # -- .ecx search (reference: SearchNeedleFromSortedIndex) --------------

    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """-> (dat_offset, size); raises NotFoundError."""
        fd = self._ecx.fileno()
        entry_at = _search_sorted_index(fd, self.entry_size, self.ecx_size // self.entry_size,
                                        needle_id)
        if entry_at < 0:
            raise NotFoundError(needle_id)
        _, offset, size = _read_entry(fd, self.entry_size, entry_at)
        return offset, size

    # -- deletes (reference: DeleteNeedleFromEcx / RebuildEcxFile) ---------

    def delete_needle(self, needle_id: int) -> None:
        fd = self._ecx.fileno()
        entry_at = _search_sorted_index(fd, self.entry_size, self.ecx_size // self.entry_size,
                                        needle_id)
        if entry_at < 0:
            return
        _tombstone(fd, self.entry_size, self.offset_width, entry_at)
        with self._ecj_lock:
            self._ecj.seek(0, os.SEEK_END)
            self._ecj.write(needle_id.to_bytes(NEEDLE_ID_SIZE, "big"))
            self._ecj.flush()

    # -- locate + read -----------------------------------------------------

    def locate(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """-> (dat_offset, size, shard intervals for the whole record)."""
        offset, size = self.find_needle_from_ecx(needle_id)
        if size_is_deleted(size):
            raise NotFoundError(needle_id)
        intervals = self.locate_interval(offset, get_actual_size(size, self.version))
        return offset, size, intervals

    def locate_interval(self, offset: int, length: int) -> list[Interval]:
        if self.dat_file_size > 0:
            shard_size = self.dat_file_size // self.scheme.data_shards
        elif self.shards:
            shard_size = self.shard_size() - 1
        else:
            raise NotFoundError(
                f"vid {self.vid}: no .vif datFileSize and no local shards "
                "to derive the interval geometry from"
            )
        return locate_data(self.scheme, shard_size, offset, length)

    def read_interval(self, interval: Interval, fetcher=None) -> bytes:
        """Read one interval: local shard, else delegate to `fetcher`
        (signature fetcher(vid, shard_id, offset, length) -> bytes) — the
        hook where the volume server plugs remote reads / reconstruction."""
        shard_id, shard_offset = interval.to_shard_and_offset(self.scheme)
        shard = self.shards.get(shard_id)
        if shard is not None:
            data = shard.read_at(shard_offset, interval.size)
            if len(data) == interval.size:
                return data
        if fetcher is None:
            raise NotFoundError(
                f"vid {self.vid} shard {shard_id} not present and no fetcher"
            )
        return fetcher(self.vid, shard_id, shard_offset, interval.size)

    def read_needle(self, needle_id: int, fetcher=None) -> Needle:
        _, _, intervals = self.locate(needle_id)
        buf = b"".join(self.read_interval(iv, fetcher) for iv in intervals)
        return Needle.from_bytes(buf, self.version)


def _read_entry(fd: int, entry_size: int, index: int) -> tuple[int, int, int]:
    return unpack_index_entry(os.pread(fd, entry_size, index * entry_size))


def _search_sorted_index(fd: int, entry_size: int, total: int, needle_id: int) -> int:
    """The entry number of ``needle_id`` in a sorted index file of
    ``total`` entries (the .ecx), -1 when it is not there."""
    lo, hi = 0, total
    while lo < hi:
        mid = (lo + hi) // 2
        key, _, _ = _read_entry(fd, entry_size, mid)
        if key == needle_id:
            return mid
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    return -1


def _tombstone(fd: int, entry_size: int, offset_width: int, index: int) -> None:
    """Overwrite an index entry's size with the tombstone, in place: a
    4-byte pwrite, atomic at sector granularity."""
    os.pwrite(fd, (TOMBSTONE_FILE_SIZE & 0xFFFFFFFF).to_bytes(4, "big"),
              index * entry_size + NEEDLE_ID_SIZE + offset_width)


def rebuild_ecx_file(base_file_name: str, offset_width: int | None = None) -> None:
    """Replay .ecj tombstones into .ecx, then drop the journal
    (reference behavior: RebuildEcxFile, ec_volume_delete.go:51-98)."""
    ecj_path = base_file_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    if offset_width is None:
        offset_width = ec_offset_width(base_file_name)
    entry_size = index_entry_size(offset_width)
    with open(base_file_name + ".ecx", "r+b") as ecx, open(ecj_path, "rb") as ecj:
        fd = ecx.fileno()
        total = os.fstat(fd).st_size // entry_size
        while True:
            b = ecj.read(NEEDLE_ID_SIZE)
            if len(b) != NEEDLE_ID_SIZE:
                break
            at = _search_sorted_index(fd, entry_size, total, int.from_bytes(b, "big"))
            if at >= 0:
                _tombstone(fd, entry_size, offset_width, at)
    os.remove(ecj_path)
