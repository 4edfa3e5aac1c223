"""Volume: append-only .dat needle log + live .idx index.

The port's copy of the disk side of seaweedfs_tpu/storage/volume.py
(reference weed/storage/volume_read.go / volume_write.go,
volume_vacuum.go, volume_checking.go): open an existing .dat/.idx (with the
crash-recovery walk a mounted volume gets, including the index rebuild a
surviving vacuum commit marker asks for), create one, append, tombstone and
read needles, seal it durably (.vif readOnly), rewrite its replica
placement, and destroy it.  Maintenance: ``garbage_ratio`` (incremental,
from deletes and overwrites), ``vacuum`` (copying compaction through
.cpd/.cpx and an fsynced .cpt marker around the two renames, corrupt
records dropped and counted, the superblock's compaction revision + 1;
the .dat and .idx it leaves are byte-identical to the JAX package's),
``scan`` and ``rebuild_index``.  A volume that fills up is sealed and
handed to the EC pipeline (storage/erasure_coding).

Each volume applies its fsync policy (``parse_fsync_policy``: always,
interval[:N], close or never) after every append, as the JAX package does.

Storage options, as the JAX Volume's: ``needle_map_kind`` (memory, compact
or leveldb; storage/needle_map.py), ``backend_kind`` (disk, mmap or memory;
storage/backend.py; a memory volume vacuums buffer to buffer) and, for a new
volume, ``offset_width`` (4 or 5 bytes per .idx offset).  Tiering: a sealed
volume's .dat moves to an object store (``tier_upload``) and back
(``tier_download``); its .vif's ``remote`` names the object, and a volume
with such a .vif and no .dat opens read-only on a ``TieredFile``.  A tiered
volume refuses writes and vacuum, and ``destroy`` drops its object.

The native data plane (native/dataplane.py): while it holds a volume
(``_dp``), every .dat/.idx append goes through its per-volume native
appender, whichever plane the write came in on, and the map and garbage
accounting fold from its event stream; a map read folds pending events
first (``AppendIndex.before_read``), so a needle the native loop just
wrote is visible here.
Vacuum, an index rebuild, a tier upload and close take the volume off the
plane first (and the first two hand it back after the swap).
"""

from __future__ import annotations

import glob
import os
import threading
import time
from pathlib import Path

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.stats import plane
from seaweedfs_tpu_torch.storage import needle as needle_mod
from seaweedfs_tpu_torch.storage.backend import (
    LocalObjectStoreClient,
    MemoryFile,
    TieredFile,
    open_backend,
)
from seaweedfs_tpu_torch.storage.needle import CookieMismatch, Needle, NeedleError
from seaweedfs_tpu_torch.storage.needle_map import AppendIndex, MemDb, reset_persistent_map
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
        needle_map_kind: str = "memory",
        backend_kind: str = "disk",
        offset_width: int = 4,
        fsync: str = "close",
    ):
        self.id = vid
        self.collection = collection
        self.base = volume_file_name(directory, collection, vid)
        self.read_only = False
        self.needle_map_kind = needle_map_kind
        self.backend_kind = backend_kind
        self.tiered = False
        self.fsync_mode, self.fsync_interval_s = parse_fsync_policy(fsync)
        self._last_fsync = time.monotonic()
        # scrubber state (storage/scrub.py): fed into the heartbeat's
        # VolumeStat so the master's health view follows scrub findings
        self.last_scrub_at_ns = 0
        self.scrub_corrupt = 0
        # RLock: a writer holding the lock may fold native-plane events in
        # (a map read -> flush_events), which re-enters per volume
        self._write_lock = threading.RLock()
        # guards _deleted_bytes / last_append_at_ns increments against the
        # native event drainer, which must NOT take _write_lock (a writer
        # holding it may be blocked on the drainer's event lock)
        self._acct_lock = threading.Lock()
        # the native data plane holding this volume (native/dataplane.py),
        # or None: while set, every append goes through its appender
        self._dp = None
        # odd while a vacuum, an index rebuild or a tier move swaps the
        # .dat/.idx in: a read that overlapped a swap is re-read
        # (read_needle)
        self._swap_seq = 0

        dat_path = self.base + ".dat"
        exists = os.path.exists(dat_path)
        # restart-surviving last-write clock: the .dat mtime is the append
        # time of the newest needle (the EC quiet window reads it)
        self.last_append_at_ns = int(os.path.getmtime(dat_path) * 1e9) if exists else 0
        remote = None if exists or create else self._remote_info()
        if not exists and not create and remote is None:
            raise FileNotFoundError(dat_path)
        if remote is not None:
            # a sealed volume tiered off-disk: reads come from the object
            # store (reference backend/s3_backend S3BackendStorageFile)
            self._dat = TieredFile(LocalObjectStoreClient(remote["root"]), remote["key"],
                                   size=int(remote.get("fileSize", 0)) or None)
            self.tiered = True
            self.read_only = True
        else:
            if backend_kind == "memory":
                # a RAM backend over on-disk volume files would present an
                # empty volume whose .idx points at nothing: refuse, and
                # drop any stale index of an earlier ephemeral run
                if exists:
                    raise ValueError(f"volume {vid}: memory backend cannot open on-disk .dat")
                try:
                    os.remove(self.base + ".idx")
                except FileNotFoundError:
                    pass
                reset_persistent_map(self.base + ".idx")
            self._dat = open_backend(backend_kind, dat_path, create=True)
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
        self.nm = AppendIndex(self.base + ".idx", kind=needle_map_kind,
                              offset_width=self.super_block.offset_width)
        if not self.tiered and backend_kind != "memory":
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
        if self._dp is not None:
            self._dp.set_flags(self.id, flag, self.super_block.replica_placement.copy_count)
        if not persist:
            return
        info = maybe_load_volume_info(self.base + ".vif") or VolumeInfo(version=int(self.version))
        info.read_only = flag
        save_volume_info(self.base + ".vif", info)

    def set_replica_placement(self, code: str) -> None:
        """Rewrite the superblock's replica-placement byte in place
        (reference volume_super_block.go, used by
        volume.configure.replication)."""
        rp = ReplicaPlacement.parse(code)
        if rp.to_byte() > 255:
            # validate the encoding BEFORE mutating anything, or memory
            # and disk diverge on the failure path
            raise ValueError(f"replica placement {code!r} does not fit a byte")
        with self._write_lock:
            self._dat.write_at(1, bytes([rp.to_byte()]))
            self._dat.flush()
            self.super_block.replica_placement = rp
        if self._dp is not None:
            self._dp.set_flags(self.id, self.read_only, rp.copy_count)

    # -- crash recovery (reference volume_checking.go CheckVolumeDataIntegrity
    # behavioral equivalent, extended with tail replay) ---------------------

    def _recover_crash_state(self, existed: bool) -> None:
        """Make a possibly-crashed volume serveable again, in place.

        1. Remove .cpd/.cpx vacuum staging a crash mid-vacuum left behind
           (the swap never happened, so .dat/.idx are the live truth).
        2. If the vacuum COMMIT marker (.cpt) survived, the crash landed
           inside the two-rename swap window: the .dat may be compacted
           while the .idx is stale, so the index is rebuilt from the .dat
           (the marker makes this deterministic; a heuristic could not
           tell a stale index from one bit-flipped record header).
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
        end = self.dat_size()
        with self._write_lock:
            if had_marker:
                wlog.warning("volume %d: vacuum commit marker present — the crash hit the "
                             "swap window; rebuilding index from .dat", self.id)
                self.rebuild_index()
                os.remove(marker)
                end = self.dat_size()
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

    def _remote_info(self) -> dict | None:
        """The .vif's ``remote`` (backend, key, root, fileSize) when this
        volume's .dat lives in an object store, else None."""
        info = maybe_load_volume_info(self.base + ".vif")
        if info is not None and info.remote.get("key"):
            return info.remote
        return None

    def file_count(self) -> int:
        return len(self.nm.db)

    def close(self) -> None:
        if self._dp is not None:
            self._dp.unregister_volume(self)
        with self._write_lock:
            self.nm.close()
            self._dat.flush()
            self._dat.close()

    # -- tiering (reference backend tiering: a sealed .dat moves to an
    # object store; reads become ranged GETs) ------------------------------

    def tier_upload(self, client, key: str | None = None) -> str:
        """Move this sealed volume's .dat into ``client``'s store; the local
        .dat is removed and reads flip to the remote backend.  Returns the
        object key (default ``vol/<collection or default>/<id>.dat``)."""
        if not self.read_only:
            raise NeedleError(f"volume {self.id}: tier requires readonly")
        if self.tiered:
            raise NeedleError(f"volume {self.id} already tiered")
        if self._dp is not None:  # the local .dat is about to disappear
            self._dp.unregister_volume(self)
        key = key or f"vol/{self.collection or 'default'}/{self.id}.dat"
        with self._write_lock:
            self._dat.flush()
            size = self._dat.size()
            client.put(key, self.base + ".dat")
            info = maybe_load_volume_info(self.base + ".vif") or VolumeInfo(
                version=int(self.version))
            info.remote = {"backend": client.name, "key": key,
                           "root": getattr(client, "root", ""), "fileSize": size}
            save_volume_info(self.base + ".vif", info)
            self._swap_seq += 1
            self._dat.close()
            os.remove(self.base + ".dat")
            self._dat = TieredFile(client, key, size=size)
            self.tiered = True
            self._swap_seq += 1
        return key

    def tier_download(self, client) -> None:
        """Bring a tiered volume's .dat back to local disk (it stays
        sealed) and drop the object."""
        remote = self._remote_info()
        if not self.tiered or remote is None:
            raise NeedleError(f"volume {self.id} is not tiered")
        with self._write_lock:
            client.get(remote["key"], self.base + ".dat")
            info = maybe_load_volume_info(self.base + ".vif")
            info.remote = {}
            save_volume_info(self.base + ".vif", info)
            client.delete(remote["key"])
            self._swap_seq += 1
            self._dat = open_backend(self.backend_kind, self.base + ".dat")
            self.tiered = False
            self._swap_seq += 1

    def destroy(self) -> None:
        remote = self._remote_info() if self.tiered else None
        self.close()
        if remote is not None:
            # best effort: the tiered object goes with the volume
            try:
                LocalObjectStoreClient(remote["root"]).delete(remote["key"])
            except OSError:
                pass
        reset_persistent_map(self.base + ".idx")
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
            if end % NEEDLE_PADDING_SIZE and self._dp is None:
                # with the native appender attached, fstat may see the
                # partial bytes of a failed native write that its own end
                # tracking overwrites: its end is the append position
                raise NeedleError(f"volume {self.id} misaligned end {end}")
            if end >= max_volume_size(self.offset_width) and n.data:
                raise VolumeFullError(f"volume {self.id} exceeded max size")
            with self._acct_lock:  # the event drainer advances this clock too
                n.append_at_ns = max(time.time_ns(), self.last_append_at_ns + 1)
                self.last_append_at_ns = n.append_at_ns
            record = n.to_bytes(self.version)
            dp = self._dp
            if dp is not None:
                off = dp.append(self.id, n.id, n.size, record)
                if off <= -2:
                    # native IO failure: partial bytes may sit past the end,
                    # and an append through our own fd would land misaligned
                    raise NeedleError(f"volume {self.id}: native append IO failure")
                if off >= 0:
                    # the native appender wrote .dat + .idx and queued the
                    # map event; all map and accounting state folds from
                    # that one ordered stream.  Fold now: read-your-write.
                    dp.flush_events()
                    # the native appender never syncs: the fsync policy
                    # applies here (fsync is per file, so our fds serve)
                    self._maybe_sync_locked()
                    return off, n.size
                # taken off the plane mid-flight (vacuum): append here
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
            dp = self._dp
            dp_off = dp.append(self.id, needle_id, -1, record) if dp else -1
            if dp_off == -2:
                raise NeedleError(f"volume {self.id}: native append IO failure")
            if dp_off >= 0 or dp_off == -3:
                # map removal and accounting ride the event stream (-3: a
                # concurrent delete tombstoned it first, the same outcome)
                dp.flush_events()
                self._maybe_sync_locked()
            else:
                self._dat.append(record)
                self.nm.delete(needle_id)
                self._maybe_sync_locked()
                with self._acct_lock:
                    self._deleted_bytes += get_actual_size(nv.size, self.version) + len(record)
            return get_actual_size(nv.size, self.version)

    # -- read path ---------------------------------------------------------

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        # reads take no lock; one that overlapped a vacuum's swap (the old
        # .dat closed, the index and the file from different generations)
        # is re-read from the new files instead of failing
        while True:
            seq = self._swap_seq
            if seq & 1:
                time.sleep(0.001)
                continue
            try:
                n = self._read_record(needle_id)
            except (NeedleError, NotFoundError, OSError, ValueError):
                if seq != self._swap_seq:
                    continue
                raise
            if seq == self._swap_seq:
                break
        if cookie is not None and n.cookie != cookie:
            raise CookieMismatch(f"needle {needle_id:x} cookie mismatch")
        return n

    def _read_record(self, needle_id: int) -> Needle:
        nv = self.nm.get(needle_id)
        if nv is None or not size_is_valid(nv.size):
            raise NotFoundError(needle_id)
        buf = self._pread(nv.offset, get_actual_size(nv.size, self.version))
        n = Needle.from_bytes(buf, self.version)
        if n.id != needle_id:
            raise NeedleError(f"read id mismatch at {nv.offset}: {n.id:x} != {needle_id:x}")
        return n

    def _pread(self, offset: int, length: int) -> bytes:
        return self._dat.read_at(offset, length)

    # -- maintenance -------------------------------------------------------

    def _fold(self) -> None:
        """Fold the native plane's pending write events in (its deletes
        and overwrites move the garbage accounting)."""
        if self._dp is not None:
            self._dp.flush_events()

    def deleted_bytes(self) -> int:
        """.dat bytes not referenced by live needles (tombstoned or
        overwritten): the numerator of the garbage ratio."""
        self._fold()
        return self._deleted_bytes

    def garbage_ratio(self) -> float:
        """Fraction of .dat bytes not referenced by live needles."""
        self._fold()
        size = self.dat_size() - SUPER_BLOCK_SIZE
        if size <= 0:
            return 0.0
        return min(1.0, self._deleted_bytes / size)

    def _vacuum_record_ok(self, nv, record: bytes) -> bool:
        """CRC-gate one record on the vacuum copy path: compaction never
        launders corrupt bytes into a fresh .dat where nothing would look
        at them again.  A corrupt record is skipped loudly (offset logged,
        metric counted); the scrubber repairs from a replica or EC."""
        try:
            Needle.from_bytes(record, self.version)
            return True
        except NeedleError as e:
            stats.DISK_CORRUPTION.inc(path="vacuum")
            wlog.warning("volume %d: corrupt needle %x at offset %d dropped by vacuum: %s",
                         self.id, nv.key, nv.offset, e)
            return False

    def vacuum(self) -> int:
        """Copying compaction: rewrite only live needles, in key order,
        into .cpd/.cpx, then swap them in (reference volume_vacuum.go).
        Writes to this volume wait on the write lock for the whole copy.
        Returns the bytes reclaimed."""
        with plane.tagged(plane.VACUUM):
            return self._vacuum()

    def _vacuum(self) -> int:
        if self.tiered:
            raise NeedleError(f"volume {self.id} is tiered (sealed)")
        if self.backend_kind == "memory":
            return self._vacuum_in_memory()
        # off the native plane BEFORE copying: its writers fall back to the
        # Python path, which waits on _write_lock until the swap is done
        # (then the volume goes back to the plane over the fresh files)
        dp = self._dp
        if dp is not None:
            dp.unregister_volume(self)
        with self._write_lock:
            old_size = self.dat_size()
            cpd, cpx = self.base + ".cpd", self.base + ".cpx"
            new_db = MemDb()
            with open(cpd, "wb") as out:
                sb = SuperBlock(
                    version=self.version,
                    replica_placement=self.super_block.replica_placement,
                    ttl=self.super_block.ttl,
                    compaction_revision=self.super_block.compaction_revision + 1,
                    offset_width=self.offset_width,
                )
                out.write(sb.to_bytes())
                for nv in self.nm.db.ascending():
                    record = self._pread(nv.offset, get_actual_size(nv.size, self.version))
                    if not self._vacuum_record_ok(nv, record):
                        continue  # logged + counted; never copy corruption
                    new_off = out.tell()
                    out.write(record)
                    new_db.set(nv.key, new_off, nv.size)
            new_db.save_to_idx(cpx, self.offset_width)
            # the commit marker brackets the two renames: a crash inside
            # the window leaves .cpt on disk, and recovery then knows the
            # .idx may be stale and rebuilds it from the .dat
            marker = self.base + ".cpt"
            with open(marker, "wb") as mf:
                mf.flush()
                os.fsync(mf.fileno())
            self._swap_seq += 1
            self.nm.close()
            self._dat.close()
            os.replace(cpd, self.base + ".dat")
            os.replace(cpx, self.base + ".idx")
            os.remove(marker)
            reset_persistent_map(self.base + ".idx")
            # a new backend over the new file: an mmap volume maps the
            # compacted .dat, never the one it replaced
            self._dat = open_backend(self.backend_kind, self.base + ".dat")
            self.super_block = SuperBlock.from_bytes(self._pread(0, SUPER_BLOCK_SIZE))
            self.nm = AppendIndex(self.base + ".idx", kind=self.needle_map_kind,
                                  offset_width=self.offset_width)
            self._deleted_bytes = 0  # compaction kept only live needles
            self._swap_seq += 1
            if dp is not None:
                dp.register_volume(self)
            return old_size - self.dat_size()

    def _vacuum_in_memory(self) -> int:
        """Compaction for the RAM backend: the .dat never touches disk, so
        the copy runs buffer to buffer and only the .idx is rewritten."""
        with self._write_lock:
            old_size = self.dat_size()
            new_dat = MemoryFile()
            sb = SuperBlock(
                version=self.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision + 1,
                offset_width=self.offset_width,
            )
            new_dat.append(sb.to_bytes())
            new_db = MemDb()
            for nv in self.nm.db.ascending():
                record = self._pread(nv.offset, get_actual_size(nv.size, self.version))
                if not self._vacuum_record_ok(nv, record):
                    continue
                new_db.set(nv.key, new_dat.append(record), nv.size)
            self._swap_seq += 1
            self.nm.close()
            new_db.save_to_idx(self.base + ".idx", self.offset_width)
            reset_persistent_map(self.base + ".idx")
            self._dat = new_dat
            self.super_block = sb
            self.nm = AppendIndex(self.base + ".idx", kind=self.needle_map_kind,
                                  offset_width=self.offset_width)
            self._deleted_bytes = 0
            self._swap_seq += 1
            return old_size - self.dat_size()

    def scan(self, verify_crc: bool = False):
        """Yield (offset, Needle) for every record in the .dat log
        (superseded and tombstone records included).  With ``verify_crc``
        a corrupt record is logged with its offset, counted and skipped
        (record boundaries come from the header, so the walk goes on)."""
        end = self.dat_size()
        off = SUPER_BLOCK_SIZE
        while off + NEEDLE_HEADER_SIZE <= end:
            n = Needle.parse_header(self._pread(off, NEEDLE_HEADER_SIZE))
            total = NEEDLE_HEADER_SIZE + needle_mod.body_length(max(n.size, 0), self.version)
            if off + total > end:
                break
            buf = self._pread(off, total)
            try:
                yield off, Needle.from_bytes(buf, self.version, verify_crc=verify_crc)
            except NeedleError as e:
                stats.DISK_CORRUPTION.inc(path="scan")
                wlog.warning("volume %d: corrupt needle %x at offset %d (%d bytes) skipped "
                             "during scan: %s", self.id, n.id, off, total, e)
            off += total

    def rebuild_index(self) -> None:
        """Recreate .idx by scanning .dat (the reference's `weed fix`).
        Records that fail their CRC are skipped with a logged offset."""
        dp = self._dp
        if dp is not None:  # the .idx is rewritten in place: re-home native fds
            dp.unregister_volume(self)
        with self._write_lock:
            db = MemDb()
            for off, n in self.scan(verify_crc=True):
                if n.size > 0 and n.data:
                    db.set(n.id, off, n.size)
                elif n.size == 0:
                    db.delete(n.id)
            self._swap_seq += 1
            self.nm.close()
            db.save_to_idx(self.base + ".idx", self.offset_width)
            reset_persistent_map(self.base + ".idx")
            self.nm = AppendIndex(self.base + ".idx", kind=self.needle_map_kind,
                                  offset_width=self.offset_width)
            self._swap_seq += 1
            if dp is not None:
                dp.register_volume(self)
