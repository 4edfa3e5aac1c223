"""A small embedded log-structured merge KV store.

The port's copy of seaweedfs_tpu/util/lsm.py (the role leveldb plays in
the reference's needle-map kinds, weed/storage/needle_map_leveldb.go),
built on the stdlib: write-ahead log -> sorted memtable -> immutable
sorted-table files, merged on read, compacted when tables pile up.  The
layout below is byte-for-byte the JAX package's, so each package opens
the other's directories.  One repair: ``scan`` ranks equal keys of
several tables by age (the newest wins); the JAX module's merge tags every
table with one priority, so there a key overwritten across two tables
scans to whichever value sorts first, or raises on a tombstone.

On-disk layout inside ``dir_path``:
  wal.log              current write-ahead log (replayed on open)
  <seq:010d>.sst       immutable sorted tables, higher seq = newer

WAL record:  u32 crc32 | u8 op(0=put 1=del) | u32 klen | u32 vlen | key | val
SST record:  u32 klen | i32 vlen (-1 = tombstone) | key | val
SST footer:  u64 index_offset | b"LSM1"
SST index:   repeated (u32 klen | key | u64 record_offset), sorted by key
"""

from __future__ import annotations

import bisect
import heapq
import os
import struct
import threading
import zlib
from typing import Iterator

_TOMBSTONE = object()
_FOOTER = struct.Struct("<Q4s")
_MAGIC = b"LSM1"


class _SSTable:
    """Immutable sorted table: keys + record offsets in memory, values
    pread on demand."""

    def __init__(self, path: str):
        self.path = path
        self.keys: list[bytes] = []
        self.offsets: list[int] = []
        self._fh = open(path, "rb")
        self._load_index()

    def _load_index(self) -> None:
        self._fh.seek(0, os.SEEK_END)
        size = self._fh.tell()
        self._fh.seek(size - _FOOTER.size)
        index_offset, magic = _FOOTER.unpack(self._fh.read(_FOOTER.size))
        if magic != _MAGIC:
            raise IOError(f"{self.path}: bad sstable footer")
        self._fh.seek(index_offset)
        blob = self._fh.read(size - _FOOTER.size - index_offset)
        pos = 0
        while pos < len(blob):
            (klen,) = struct.unpack_from("<I", blob, pos)
            pos += 4
            key = blob[pos : pos + klen]
            pos += klen
            (off,) = struct.unpack_from("<Q", blob, pos)
            pos += 8
            self.keys.append(key)
            self.offsets.append(off)

    def get(self, key: bytes):
        """Returns value bytes, _TOMBSTONE, or None (absent)."""
        i = bisect.bisect_left(self.keys, key)
        if i >= len(self.keys) or self.keys[i] != key:
            return None
        return self._read_value(self.offsets[i])

    def _read_value(self, offset: int):
        self._fh.seek(offset)
        klen, vlen = struct.unpack("<Ii", self._fh.read(8))
        self._fh.seek(klen, os.SEEK_CUR)
        if vlen < 0:
            return _TOMBSTONE
        return self._fh.read(vlen)

    def scan(self, start: bytes, stop: bytes | None) -> Iterator[tuple[bytes, object]]:
        i = bisect.bisect_left(self.keys, start)
        while i < len(self.keys):
            key = self.keys[i]
            if stop is not None and key >= stop:
                return
            yield key, self._read_value(self.offsets[i])
            i += 1

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def write(path: str, items: list[tuple[bytes, object]]) -> None:
        """Write sorted (key, value|_TOMBSTONE) items + index + footer."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            index: list[tuple[bytes, int]] = []
            for key, val in items:
                index.append((key, fh.tell()))
                if val is _TOMBSTONE:
                    fh.write(struct.pack("<Ii", len(key), -1) + key)
                else:
                    fh.write(struct.pack("<Ii", len(key), len(val)) + key + val)
            index_offset = fh.tell()
            for key, off in index:
                fh.write(struct.pack("<I", len(key)) + key + struct.pack("<Q", off))
            fh.write(_FOOTER.pack(index_offset, _MAGIC))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)


def _tagged(items: Iterator[tuple[bytes, object]], prio: int) -> Iterator[tuple]:
    # a function, not a generator expression in scan's loop: the
    # expression would read the loop's ``prio`` late, give every table
    # the oldest one's priority, and let the merge order equal keys by
    # value (or fail comparing a tombstone), not by age
    for k, v in items:
        yield k, prio, v


class LsmStore:
    def __init__(
        self,
        dir_path: str,
        *,
        memtable_bytes: int = 4 * 1024 * 1024,
        compact_threshold: int = 8,
    ):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.memtable_bytes = memtable_bytes
        self.compact_threshold = compact_threshold
        self._mem: dict[bytes, object] = {}
        self._mem_size = 0
        self._io_lock = threading.RLock()
        self._tables: list[_SSTable] = []  # oldest → newest
        self._seq = 0
        self._open_tables()
        self._wal_path = os.path.join(dir_path, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # ---- public API -----------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        self._write(0, key, value)

    def delete(self, key: bytes) -> None:
        self._write(1, key, b"")

    def get(self, key: bytes) -> bytes | None:
        with self._io_lock:
            if key in self._mem:
                val = self._mem[key]
                return None if val is _TOMBSTONE else val
            for table in reversed(self._tables):
                val = table.get(key)
                if val is not None:
                    return None if val is _TOMBSTONE else val
        return None

    def scan(
        self, start: bytes = b"", stop: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        """Ordered (key, value) over [start, stop); newest layer wins."""
        with self._io_lock:
            sources: list[Iterator] = []
            # priority: lower number wins on equal keys
            mem_items = sorted(
                (k, v)
                for k, v in self._mem.items()
                if k >= start and (stop is None or k < stop)
            )
            sources.append(((k, 0, v) for k, v in mem_items))
            for prio, table in enumerate(reversed(self._tables), start=1):
                sources.append(_tagged(table.scan(start, stop), prio))
            merged = heapq.merge(*sources)
            last_key = None
            for key, _prio, val in merged:
                if key == last_key:
                    continue
                last_key = key
                if val is not _TOMBSTONE:
                    yield key, val

    def flush(self) -> None:
        with self._io_lock:
            self._flush_memtable_locked()

    def close(self) -> None:
        with self._io_lock:
            self._flush_memtable_locked()
            self._wal.close()
            for t in self._tables:
                t.close()
            self._tables = []

    # ---- internals ------------------------------------------------------
    def _write(self, op: int, key: bytes, value: bytes) -> None:
        body = struct.pack("<BII", op, len(key), len(value)) + key + value
        rec = struct.pack("<I", zlib.crc32(body)) + body
        with self._io_lock:
            self._wal.write(rec)
            self._wal.flush()
            self._mem[key] = value if op == 0 else _TOMBSTONE
            self._mem_size += len(key) + len(value) + 16
            if self._mem_size >= self.memtable_bytes:
                self._flush_memtable_locked()

    def _flush_memtable_locked(self) -> None:
        if not self._mem:
            return
        self._seq += 1
        path = os.path.join(self.dir, f"{self._seq:010d}.sst")
        _SSTable.write(path, sorted(self._mem.items()))
        self._tables.append(_SSTable(path))
        self._mem = {}
        self._mem_size = 0
        self._wal.close()
        self._wal = open(self._wal_path, "wb")  # truncate: contents now durable
        if len(self._tables) >= self.compact_threshold:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Merge every table into one, dropping shadowed values and
        tombstones (full compaction — there is no older layer left that a
        tombstone still needs to mask)."""
        merged: dict[bytes, object] = {}
        for table in self._tables:  # oldest → newest, newer overwrites
            for key, val in table.scan(b"", None):
                merged[key] = val
        items = sorted(
            (k, v) for k, v in merged.items() if v is not _TOMBSTONE
        )
        self._seq += 1
        path = os.path.join(self.dir, f"{self._seq:010d}.sst")
        _SSTable.write(path, items)
        old = self._tables
        self._tables = [_SSTable(path)]
        for t in old:
            t.close()
            os.remove(t.path)

    def _open_tables(self) -> None:
        for name in sorted(os.listdir(self.dir)):
            if name.endswith(".sst"):
                self._tables.append(_SSTable(os.path.join(self.dir, name)))
                self._seq = max(self._seq, int(name.split(".")[0]))

    def _replay_wal(self) -> None:
        if not os.path.exists(self._wal_path):
            return
        with open(self._wal_path, "rb") as fh:
            blob = fh.read()
        pos = 0
        while pos + 13 <= len(blob):
            (crc,) = struct.unpack_from("<I", blob, pos)
            op, klen, vlen = struct.unpack_from("<BII", blob, pos + 4)
            end = pos + 13 + klen + vlen
            if end > len(blob) or zlib.crc32(blob[pos + 4 : end]) != crc:
                break  # torn/corrupt tail from a crash — discard the rest
            key = blob[pos + 13 : pos + 13 + klen]
            val = blob[pos + 13 + klen : end]
            self._mem[key] = val if op == 0 else _TOMBSTONE
            self._mem_size += klen + vlen + 16
            pos = end
