"""Needle maps: id -> (offset, size) indexes in three kinds, plus .idx I/O.

The port's copy of seaweedfs_tpu/storage/needle_map.py.  The .idx file is
an append-only log of 16-byte entries (17 with 5-byte offsets; the
reference's layout, weed/storage/needle_map/needle_value.go ToBytes); a
deletion appends an entry with zero offset and tombstone size.  Map kinds
mirror the reference's NeedleMapInMemory / CompactMap / LevelDb kinds
(weed/storage/needle_map.go:17-20, needle_map/compact_map.go,
needle_map_leveldb.go):

- ``MemDb``: dict replay of the log; simplest, heaviest per entry.
- ``CompactMap``: a numpy-columnar sorted base plus a small dict overlay
  (about 24 bytes per entry), binary-search gets, vectorized folds.
- ``LevelDbNeedleMap``: backed by util/lsm.LsmStore beside the .idx
  (``<base>.idx.ldb``) with a durable high-water mark of indexed .idx
  bytes, so reopening a large volume replays only the .idx tail.  Its
  keys, values and meta key are the JAX package's, so each package opens
  the other's ``.ldb``.

``AppendIndex`` is the live .idx writer of an open volume over one of
them; ``walk_index_file`` also serves the EC decoder.  ``MemDb.ascending``
and ``save_to_idx`` write the compacted index of a vacuum and of an index
rebuild, and ``reset_persistent_map`` drops the LSM map such a rewrite
invalidates.  (The encoder replays the log in bulk:
ec_encoder.write_sorted_ecx_file.)
"""

from __future__ import annotations

import io
import logging
import os
import shutil
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from seaweedfs_tpu_torch.storage.types import (
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    index_entry_size,
    pack_index_entry,
    size_is_deleted,
    unpack_index_entry,
)

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset: int  # actual byte offset
    size: int

    def to_bytes(self, offset_width: int = OFFSET_SIZE) -> bytes:
        return pack_index_entry(self.key, self.offset, self.size, offset_width)


def walk_index_file(
    f: io.BufferedIOBase | io.RawIOBase,
    fn: Callable[[int, int, int], None],
    start: int = 0,
    offset_width: int = OFFSET_SIZE,
    strict: bool = False,
) -> int:
    """Stream (key, offset, size) entries of an .idx/.ecx file to fn.

    Returns the number of whole-entry bytes consumed (from ``start``).
    A mid-record torn tail is by default NOT an error: the whole entries
    before it are replayed and the partial record is reported via the
    return value.  Pass ``strict=True`` for sealed artifacts like a
    generated .ecx, where a torn tail means the file itself is damaged."""
    entry_size = index_entry_size(offset_width)
    f.seek(start)
    consumed = 0
    pending = b""
    while True:
        chunk = f.read(entry_size * 4096)
        if not chunk:
            if pending:
                if strict:
                    raise ValueError(
                        f"truncated index file: {len(pending)}-byte "
                        "partial tail entry"
                    )
                log.warning(
                    "needle_map: ignoring torn %d-byte index tail record",
                    len(pending),
                )
            return consumed
        chunk = pending + chunk
        whole = len(chunk) - (len(chunk) % entry_size)
        for i in range(0, whole, entry_size):
            fn(*unpack_index_entry(chunk[i : i + entry_size]))
        consumed += whole
        pending = chunk[whole:]


class MemDb:
    """Replayed view of an index log; insertion-order-independent."""

    def __init__(self) -> None:
        self._m: dict[int, NeedleValue] = {}

    def set(self, key: int, offset: int, size: int) -> None:
        self._m[key] = NeedleValue(key, offset, size)

    def delete(self, key: int) -> None:
        self._m.pop(key, None)

    def get(self, key: int) -> NeedleValue | None:
        return self._m.get(key)

    def __len__(self) -> int:
        return len(self._m)

    def ascending(self) -> Iterator[NeedleValue]:
        for key in sorted(self._m):
            yield self._m[key]

    def values(self) -> Iterator[NeedleValue]:
        """Unordered iteration, for aggregate accounting."""
        return iter(self._m.values())

    def save_to_idx(self, idx_path: str | os.PathLike, offset_width: int = OFFSET_SIZE) -> None:
        # staging + atomic rename: a crash mid-save must leave the old
        # index intact, never a half-written one
        idx_path = os.fspath(idx_path)
        tmp = idx_path + ".tmp"
        with open(tmp, "wb") as f:
            for nv in self.ascending():
                f.write(nv.to_bytes(offset_width))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, idx_path)


_COMPACT_DTYPE = np.dtype([("key", "<u8"), ("offset", "<u8"), ("size", "<i8")])


class CompactMap:
    """Sorted numpy-columnar base + dict overlay (reference CompactMap,
    needle_map/compact_map.go, array-first): lookups binary-search the
    base with np.searchsorted; writes land in the overlay and fold into
    the base, vectorized, once it grows past ``fold_at``."""

    def __init__(self, fold_at: int = 16384):
        self._base = np.empty(0, dtype=_COMPACT_DTYPE)
        self._overlay: dict[int, tuple[int, int]] = {}  # key -> (off, size); size<0 = tombstone
        self.fold_at = fold_at
        # folds are triggered from reader paths (len/ascending) too, e.g.
        # the heartbeat thread's file_count() racing an HTTP write, so
        # every structural access serializes here
        self._lock = threading.RLock()

    def set(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            self._overlay[key] = (offset, size)
            if len(self._overlay) >= self.fold_at:
                self._fold_locked()

    def delete(self, key: int) -> None:
        with self._lock:
            self._overlay[key] = (0, -1)
            if len(self._overlay) >= self.fold_at:
                self._fold_locked()

    def _fold_locked(self) -> None:
        if not self._overlay:
            return
        over = np.fromiter(((k, o, s) for k, (o, s) in self._overlay.items()),
                           dtype=_COMPACT_DTYPE, count=len(self._overlay))
        merged = np.concatenate([self._base, over])
        # the stable sort keeps the overlay (appended last) after the base
        # on equal keys; keep the last occurrence per key, then drop
        # tombstones
        merged = merged[np.argsort(merged["key"], kind="stable")]
        keys = merged["key"]
        last = np.ones(len(merged), dtype=bool)
        if len(merged) > 1:
            last[:-1] = keys[:-1] != keys[1:]
        merged = merged[last]
        self._base = merged[merged["size"] >= 0]
        self._overlay = {}

    def get(self, key: int) -> NeedleValue | None:
        with self._lock:
            if key in self._overlay:
                off, size = self._overlay[key]
                return None if size < 0 else NeedleValue(key, off, size)
            i = np.searchsorted(self._base["key"], key)
            if i < len(self._base) and int(self._base["key"][i]) == key:
                row = self._base[i]
                return NeedleValue(key, int(row["offset"]), int(row["size"]))
            return None

    def __len__(self) -> int:
        with self._lock:
            self._fold_locked()
            return len(self._base)

    def ascending(self) -> Iterator[NeedleValue]:
        with self._lock:
            self._fold_locked()
            base = self._base  # a folded base is never mutated: iterate lock-free
        for row in base:
            yield NeedleValue(int(row["key"]), int(row["offset"]), int(row["size"]))

    values = ascending  # already cheap; the order is free from the layout


class LevelDbNeedleMap:
    """LSM-backed persistent map (reference needle_map_leveldb.go): keys
    are 8-byte big-endian needle ids (numeric order == byte order), values
    packed (offset, size).  A meta key records how many .idx bytes have
    been indexed, so reopening replays only the tail."""

    _META_OFFSET = b"\x00meta:idx_offset"
    _VALUE = struct.Struct("<Qi")

    def __init__(self, kv_dir: str):
        from seaweedfs_tpu_torch.util.lsm import LsmStore

        self.kv = LsmStore(kv_dir)
        self._count: int | None = None
        # writers and the heartbeat thread's len() both touch _count; the
        # first recount must not interleave with writers either
        self._io_lock = threading.RLock()

    def set(self, key: int, offset: int, size: int) -> None:
        kb = key.to_bytes(8, "big")
        with self._io_lock:
            # the existence probe is an in-memory bisect (memtable + SST
            # indexes), noise next to the needle's disk write it follows
            if self._count is not None and self.kv.get(kb) is None:
                self._count += 1
            self.kv.put(kb, self._VALUE.pack(offset, size))

    def delete(self, key: int) -> None:
        kb = key.to_bytes(8, "big")
        with self._io_lock:
            if self._count is not None and self.kv.get(kb) is not None:
                self._count -= 1
            self.kv.delete(kb)

    def get(self, key: int) -> NeedleValue | None:
        blob = self.kv.get(key.to_bytes(8, "big"))
        if blob is None:
            return None
        offset, size = self._VALUE.unpack(blob)
        return NeedleValue(key, offset, size)

    def __len__(self) -> int:
        with self._io_lock:
            if self._count is None:
                self._count = sum(1 for _ in self._scan())
            return self._count

    def _scan(self):
        # needle keys are exactly 8 bytes and meta keys longer: length is
        # the namespace (a byte prefix cannot be, most ids start with \x00)
        for kb, blob in self.kv.scan():
            if len(kb) == 8:
                yield kb, blob

    def ascending(self) -> Iterator[NeedleValue]:
        for kb, blob in self._scan():
            offset, size = self._VALUE.unpack(blob)
            yield NeedleValue(int.from_bytes(kb, "big"), offset, size)

    values = ascending

    @property
    def indexed_idx_bytes(self) -> int:
        """The durable high-water mark: .idx bytes already in the map."""
        blob = self.kv.get(self._META_OFFSET)
        return int(blob) if blob else 0

    def mark_indexed(self, idx_bytes: int) -> None:
        self.kv.put(self._META_OFFSET, str(idx_bytes).encode())

    def close(self) -> None:
        self.kv.close()


def reset_persistent_map(idx_path: str | os.PathLike) -> None:
    """Drop the LSM map beside an .idx that was rewritten in place (vacuum,
    index rebuild): the tail replay is sound only over an append-only log,
    so a rewrite invalidates the whole map."""
    shutil.rmtree(os.fspath(idx_path) + ".ldb", ignore_errors=True)


class AppendIndex:
    """Live append-only .idx writer backing an open volume.

    ``kind`` picks the in-process map: "memory" (MemDb), "compact"
    (CompactMap) or "leveldb" (LSM-persisted beside the .idx; a restart
    replays only the un-indexed .idx tail, and a .idx shorter than the
    map's mark, rewritten since, rebuilds the map).

    ``before_read`` (set while the native data plane holds the volume) is
    called before the map is read through ``db`` and on a ``get`` miss: it
    folds the plane's pending write events in, so a reader sees every
    write that was acknowledged before it looked."""

    before_read = None

    def __init__(self, idx_path: str | os.PathLike, kind: str = "memory",
                 offset_width: int = OFFSET_SIZE):
        self.path = os.fspath(idx_path)
        self.kind = kind
        self.offset_width = offset_width
        self._truncate_torn_tail()
        self._f = open(self.path, "ab")
        idx_size = os.path.getsize(self.path)
        if kind == "leveldb":
            self._db = LevelDbNeedleMap(self.path + ".ldb")
            start = self._db.indexed_idx_bytes
            if start > idx_size:  # the .idx was truncated or replaced: rebuild
                self._db.close()
                reset_persistent_map(self.path)
                self._db = LevelDbNeedleMap(self.path + ".ldb")
                start = 0
            if start < idx_size:
                self._replay(start)
                self._db.mark_indexed(idx_size)
        else:
            self._db = MemDb() if kind == "memory" else CompactMap()
            if idx_size:
                self._replay(0)

    @property
    def db(self):
        """The live map, with pending native write events folded in."""
        if self.before_read is not None:
            self.before_read()
        return self._db

    def _truncate_torn_tail(self) -> None:
        """Drop a mid-record torn .idx tail (crash between the bytes of
        one entry): truncate to the last whole entry so replay parses
        cleanly and future appends land entry-aligned.  The needle the
        partial entry described is re-indexed by the volume's torn-tail
        .dat walk if its record survived."""
        try:
            size = os.path.getsize(self.path)
        except FileNotFoundError:
            return
        rem = size % index_entry_size(self.offset_width)
        if rem:
            from seaweedfs_tpu_torch.util import wlog

            wlog.info("needle_map: %s has a torn %d-byte tail record; truncating %d -> %d",
                      self.path, rem, size, size - rem)
            os.truncate(self.path, size - rem)

    def _replay(self, start: int) -> None:
        db = self._db

        def visit(key: int, offset: int, size: int) -> None:
            if offset > 0 and not size_is_deleted(size):
                db.set(key, offset, size)
            else:
                db.delete(key)

        with open(self.path, "rb") as f:
            walk_index_file(f, visit, start=start, offset_width=self.offset_width)

    def put(self, key: int, offset: int, size: int) -> None:
        self._f.write(pack_index_entry(key, offset, size, self.offset_width))
        self._f.flush()  # .idx must be on disk for EC generate / crash rebuild
        self._db.set(key, offset, size)

    # entries whose .idx bytes were already written elsewhere (the native
    # data plane appends the .idx itself): only the live map changes
    def apply_put(self, key: int, offset: int, size: int) -> None:
        self._db.set(key, offset, size)

    def apply_delete(self, key: int) -> None:
        self._db.delete(key)

    def delete(self, key: int) -> None:
        self._f.write(pack_index_entry(key, 0, TOMBSTONE_FILE_SIZE, self.offset_width))
        self._f.flush()
        self._db.delete(key)

    def get(self, key: int) -> NeedleValue | None:
        nv = self._db.get(key)
        if nv is None and self.before_read is not None:
            self.before_read()  # a native write may not have folded in yet
            nv = self._db.get(key)
        return nv

    def flush(self) -> None:
        self._f.flush()
        if self.kind == "leveldb":
            self._db.mark_indexed(os.path.getsize(self.path))

    def sync(self) -> None:
        """fsync the .idx (the volume fsync policy's index half)."""
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.flush()
        try:
            os.fsync(self._f.fileno())  # durable clean close, like the .dat
        except OSError:
            pass
        self._f.close()
        if self.kind == "leveldb":
            # the tail replay is idempotent, so the high-water mark needs
            # to be durable only at a clean close
            self._db.mark_indexed(os.path.getsize(self.path))
            self._db.close()
