"""Volume: append-only .dat needle log + live .idx index.

The port's copy of the sealed-volume side of seaweedfs_tpu/storage/
volume.py (reference weed/storage/volume_read.go / volume_write.go,
volume_checking.go): open an existing .dat/.idx (with the crash-recovery
walk a mounted volume gets), create one, append, tombstone and read
needles, seal it durably (.vif readOnly), and destroy it.  A volume that
fills up is sealed and handed to the EC pipeline (storage/erasure_coding).

Each volume applies its fsync policy (``parse_fsync_policy``: always,
interval[:N], close or never) after every append, as the JAX package does.

Not ported: the needle-map kinds other than memory, the memory backend, the native data plane, tiering, vacuum,
``scan`` and ``rebuild_index`` (a volume whose vacuum commit marker
survived a crash, which needs the index rebuilt from its .dat, is refused
at open).
"""

from __future__ import annotations

import glob
import os
import threading
import time
from pathlib import Path

from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage.backend import open_backend
from seaweedfs_tpu_torch.storage.needle import CookieMismatch, Needle, NeedleError
from seaweedfs_tpu_torch.storage.needle_map import AppendIndex
from seaweedfs_tpu_torch.storage.super_block import (
    SUPER_BLOCK_SIZE,
    ReplicaPlacement,
    SuperBlock,
    ttl_from_seconds,
)
from seaweedfs_tpu_torch.storage.types import (
    CURRENT_VERSION,
    NEEDLE_HEADER_SIZE,
    NEEDLE_PADDING_SIZE,
    Version,
    get_actual_size,
    max_volume_size,
    size_is_valid,
)
from seaweedfs_tpu_torch.storage.volume_info import (
    VolumeInfo,
    maybe_load_volume_info,
    save_volume_info,
)
from seaweedfs_tpu_torch.util import wlog


class VolumeFullError(Exception):
    pass


class NotFoundError(KeyError):
    pass


def parse_fsync_policy(spec: str) -> tuple[str, float]:
    """-> (mode, interval_s).  Modes: ``always`` fsync .dat+.idx after
    every write; ``interval[:N]`` fsync opportunistically at most every N
    seconds (default 5) on the write path; ``close`` only on clean close
    (the backend does that unconditionally); ``never`` documents that the
    caller accepts page-cache durability."""
    spec = (spec or "close").strip().lower()
    mode, _, arg = spec.partition(":")
    if mode not in ("always", "interval", "close", "never"):
        raise ValueError(f"unknown fsync policy {spec!r}")
    interval = 5.0
    if mode == "interval" and arg:
        interval = float(arg)
        if interval <= 0:
            raise ValueError(f"fsync interval must be positive: {spec!r}")
    return mode, interval


def volume_file_name(directory: str | os.PathLike, collection: str, vid: int) -> str:
    base = f"{collection}_{vid}" if collection else str(vid)
    return str(Path(directory) / base)


class Volume:
    """One open volume. Thread-safe for concurrent reads + serialized writes."""

    def __init__(
        self,
        directory: str | os.PathLike,
        vid: int,
        collection: str = "",
        replica_placement: str = "000",
        version: Version = CURRENT_VERSION,
        create: bool = True,
        ttl_seconds: int = 0,
        offset_width: int = 4,
        fsync: str = "close",
    ):
        self.id = vid
        self.collection = collection
        self.base = volume_file_name(directory, collection, vid)
        self.read_only = False
        self.fsync_mode, self.fsync_interval_s = parse_fsync_policy(fsync)
        self._last_fsync = time.monotonic()
        # scrubber state, reported in the heartbeat's VolumeStat (the
        # scrubber itself is not ported: these stay 0)
        self.last_scrub_at_ns = 0
        self.scrub_corrupt = 0
        self._write_lock = threading.RLock()
        # guards _deleted_bytes / last_append_at_ns increments
        self._acct_lock = threading.Lock()

        dat_path = self.base + ".dat"
        exists = os.path.exists(dat_path)
        # restart-surviving last-write clock: the .dat mtime is the append
        # time of the newest needle (the EC quiet window reads it)
        self.last_append_at_ns = int(os.path.getmtime(dat_path) * 1e9) if exists else 0
        if not exists and not create:
            raise FileNotFoundError(dat_path)
        self._dat = open_backend("disk", dat_path, create=True)
        if self._dat.size() >= SUPER_BLOCK_SIZE:
            self.super_block = SuperBlock.from_bytes(self._dat.read_at(0, SUPER_BLOCK_SIZE))
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=ReplicaPlacement.parse(replica_placement),
                ttl=ttl_from_seconds(ttl_seconds),
                offset_width=offset_width,
            )
            # write_at(0), not append: a creation crash can leave a short
            # .dat whose partial superblock must be overwritten
            self._dat.write_at(0, self.super_block.to_bytes())
        # on reopen the superblock wins: width is a durable volume property
        self.nm = AppendIndex(self.base + ".idx", offset_width=self.super_block.offset_width)
        # crash consistency: drop vacuum staging, truncate a torn .dat
        # tail, replay un-indexed tail records into the .idx
        self._recover_crash_state(existed=exists)
        # a persisted seal (.vif readOnly) survives restarts
        info = maybe_load_volume_info(self.base + ".vif")
        if info is not None and info.read_only:
            self.read_only = True
        # incremental garbage accounting: one O(n) pass at open, then
        # updated on delete/overwrite
        self._deleted_bytes = self._compute_deleted_bytes()

    def set_read_only(self, flag: bool, persist: bool = True) -> None:
        """Seal/unseal, durably (.vif readOnly) unless persist=False."""
        self.read_only = flag
        if not persist:
            return
        info = maybe_load_volume_info(self.base + ".vif") or VolumeInfo(version=int(self.version))
        info.read_only = flag
        save_volume_info(self.base + ".vif", info)

    # -- crash recovery (reference volume_checking.go CheckVolumeDataIntegrity
    # behavioral equivalent, extended with tail replay) ---------------------

    def _recover_crash_state(self, existed: bool) -> None:
        """Make a possibly-crashed volume serveable again, in place.

        1. Remove .cpd/.cpx vacuum staging a crash mid-vacuum left behind.
        2. A surviving vacuum COMMIT marker (.cpt) means the crash hit the
           two-rename swap window and the .idx may be stale: the index
           rebuild that repairs it is not ported, so the open is refused.
        3. Tombstone .idx entries pointing past the .dat end.
        4. Walk the un-indexed .dat tail: CRC-valid records are replayed
           into the index; the first torn/corrupt one and everything after
           it is truncated away.
        """
        marker = self.base + ".cpt"
        had_marker = os.path.exists(marker)
        for ext in (".cpd", ".cpx", ".cpx.tmp", ".idx.tmp"):
            try:
                os.remove(self.base + ext)
                wlog.info("volume %d: removed stale vacuum staging %s", self.id, self.base + ext)
            except FileNotFoundError:
                pass
        if not existed:
            if had_marker:
                os.remove(marker)
            return
        if had_marker:
            self.close()
            raise ValueError(f"volume {self.id}: vacuum commit marker present; the index "
                             "rebuild from .dat it needs is not ported")
        end = self.dat_size()
        with self._write_lock:
            tail, tail_nv = self._drop_overhanging_entries_locked(end)
            if tail_nv is not None and self._entry_verdict(tail_nv) == "wrong_key":
                wlog.warning("volume %d: record at offset %d does not match its index entry "
                             "(key %x); kept for scrub diagnosis", self.id, tail_nv.offset,
                             tail_nv.key)
            off = tail
            truncate_to: int | None = None
            while off + NEEDLE_HEADER_SIZE <= end:
                n = Needle.parse_header(self._pread(off, NEEDLE_HEADER_SIZE))
                if n.size < 0:
                    truncate_to = off  # garbage: tombstone records store size 0
                    break
                total = NEEDLE_HEADER_SIZE + needle_mod.body_length(max(n.size, 0), self.version)
                if off + total > end:
                    truncate_to = off  # record extends past EOF: torn
                    break
                try:
                    full = Needle.from_bytes(self._pread(off, total), self.version)
                except NeedleError:
                    truncate_to = off  # corrupt tail record
                    break
                if full.size > 0 and full.data:
                    have = self.nm.get(full.id)
                    if have is None or (have.offset, have.size) != (off, full.size):
                        self.nm.put(full.id, off, full.size)
                        wlog.info("volume %d: replayed un-indexed needle %x at %d",
                                  self.id, full.id, off)
                elif self.nm.get(full.id) is not None:
                    # tombstone record whose .idx entry was lost
                    self.nm.delete(full.id)
                    wlog.info("volume %d: replayed un-indexed tombstone %x at %d",
                              self.id, full.id, off)
                off += total
            if truncate_to is None and off < end:
                truncate_to = off  # sub-header trailing garbage
            if truncate_to is not None and truncate_to < end:
                wlog.info("volume %d: torn .dat tail; truncating %d -> %d", self.id, end,
                          truncate_to)
                self._dat.truncate(truncate_to)
                self.nm.flush()

    def _drop_overhanging_entries_locked(self, end: int):
        """Tombstone index entries pointing past the .dat end; returns
        (end of the highest surviving indexed record, its entry)."""
        tail, tail_nv, over = SUPER_BLOCK_SIZE, None, []
        for nv in list(self.nm.db.values()):
            if not size_is_valid(nv.size):
                continue
            rec_end = nv.offset + get_actual_size(nv.size, self.version)
            if nv.offset < SUPER_BLOCK_SIZE or rec_end > end:
                over.append(nv.key)
            elif rec_end > tail:
                tail, tail_nv = rec_end, nv
        for key in over:
            wlog.info("volume %d: index entry %x points past .dat end %d; dropping (write "
                      "never fully landed)", self.id, key, end)
            self.nm.delete(key)
        return tail, tail_nv

    def _entry_verdict(self, nv) -> str:
        """``ok`` (parses, key matches), ``crc`` (right key, bad checksum)
        or ``wrong_key`` (the record is not this needle at all)."""
        buf = self._pread(nv.offset, get_actual_size(nv.size, self.version))
        header = Needle.parse_header(buf[:NEEDLE_HEADER_SIZE])
        if header.id != nv.key or header.size != nv.size:
            return "wrong_key"
        try:
            Needle.from_bytes(buf, self.version)
            return "ok"
        except NeedleError:
            return "crc"

    # -- fsync policy -------------------------------------------------------

    def sync(self) -> None:
        """fsync .dat + .idx now."""
        self._dat.sync()
        self.nm.sync()

    def _maybe_sync_locked(self) -> None:
        """Apply the volume fsync policy after a write (lock held)."""
        if self.fsync_mode == "always":
            self.sync()
        elif self.fsync_mode == "interval":
            now = time.monotonic()
            if now - self._last_fsync >= self.fsync_interval_s:
                self._last_fsync = now
                self.sync()

    def _compute_deleted_bytes(self) -> int:
        size = self.dat_size() - SUPER_BLOCK_SIZE
        if size <= 0:
            return 0
        live = sum(get_actual_size(nv.size, self.version) for nv in self.nm.db.values())
        return max(0, size - live)

    # -- basic facts -------------------------------------------------------

    @property
    def version(self) -> Version:
        return self.super_block.version

    @property
    def offset_width(self) -> int:
        return self.super_block.offset_width

    def dat_size(self) -> int:
        return self._dat.size()

    def file_count(self) -> int:
        return len(self.nm.db)

    def deleted_bytes(self) -> int:
        """.dat bytes not referenced by live needles."""
        return self._deleted_bytes

    def close(self) -> None:
        with self._write_lock:
            self.nm.close()
            self._dat.flush()
            self._dat.close()

    def destroy(self) -> None:
        self.close()
        exts = [".dat", ".idx", ".cpt"]
        # after ec.encode the .vif (DatFileSize) belongs to the EC volume;
        # deleting the original replica must not orphan the shard geometry
        if not glob.glob(glob.escape(self.base) + ".ec[0-9][0-9]"):
            exts.append(".vif")
        for ext in exts:
            try:
                os.remove(self.base + ext)
            except FileNotFoundError:
                pass

    # -- write path --------------------------------------------------------

    def write_needle(self, n: Needle) -> tuple[int, int]:
        """Append a needle; returns (offset, stored_size): the record at
        the 8-aligned end of .dat, the idx entry holding the body Size."""
        if self.read_only:
            raise NeedleError(f"volume {self.id} is read-only")
        with self._write_lock:
            end = self.dat_size()
            if end % NEEDLE_PADDING_SIZE:
                raise NeedleError(f"volume {self.id} misaligned end {end}")
            if end >= max_volume_size(self.offset_width) and n.data:
                raise VolumeFullError(f"volume {self.id} exceeded max size")
            with self._acct_lock:
                n.append_at_ns = max(time.time_ns(), self.last_append_at_ns + 1)
                self.last_append_at_ns = n.append_at_ns
            record = n.to_bytes(self.version)
            old = self.nm.get(n.id)
            end = self._dat.append(record)
            self.nm.put(n.id, end, n.size)
            self._maybe_sync_locked()
            if old is not None and size_is_valid(old.size):
                # overwrite: the superseded record is garbage now
                with self._acct_lock:
                    self._deleted_bytes += get_actual_size(old.size, self.version)
            return end, n.size

    def delete_needle(self, needle_id: int) -> int:
        """Tombstone a needle; returns reclaimed byte count (0 if absent)."""
        if self.read_only:
            raise NeedleError(f"volume {self.id} is read-only")
        with self._write_lock:
            nv = self.nm.get(needle_id)
            if nv is None or not size_is_valid(nv.size):
                return 0
            # a tombstone record (empty data) for crash safety, then the
            # index tombstone
            record = Needle(id=needle_id, cookie=0).to_bytes(self.version)
            self._dat.append(record)
            self.nm.delete(needle_id)
            self._maybe_sync_locked()
            with self._acct_lock:
                self._deleted_bytes += get_actual_size(nv.size, self.version) + len(record)
            return get_actual_size(nv.size, self.version)

    # -- read path ---------------------------------------------------------

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        nv = self.nm.get(needle_id)
        if nv is None or not size_is_valid(nv.size):
            raise NotFoundError(needle_id)
        buf = self._pread(nv.offset, get_actual_size(nv.size, self.version))
        n = Needle.from_bytes(buf, self.version)
        if n.id != needle_id:
            raise NeedleError(f"read id mismatch at {nv.offset}: {n.id:x} != {needle_id:x}")
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(f"needle {needle_id:x} cookie mismatch")
        return n

    def _pread(self, offset: int, length: int) -> bytes:
        return self._dat.read_at(offset, length)
