"""Needle maps: id -> (offset, size) indexes, plus .idx I/O.

The port's copy of the memory kind of seaweedfs_tpu/storage/needle_map.py
(reference NeedleMapInMemory, weed/storage/needle_map.go): ``MemDb``, the
dict replay of an index log, and ``AppendIndex``, the live .idx writer of
an open volume, with its torn-tail truncation and replay; and
``walk_index_file``, which the EC decoder also reads.  ``MemDb.ascending``
and ``save_to_idx`` write the compacted index of a vacuum and of an index
rebuild (sorted by key, staged and renamed), as the JAX package's do.  The .idx file is an
append-only log of 16-byte entries (same layout as the reference's,
weed/storage/needle_map/needle_value.go ToBytes); a deletion appends an
entry with zero offset and tombstone size.  (The encoder replays the log
in bulk: ec_encoder.write_sorted_ecx_file.)  ``CompactMap`` and the
LSM-backed ``LevelDbNeedleMap`` are not ported.
"""

from __future__ import annotations

import io
import logging
import os
from dataclasses import dataclass
from typing import Callable, Iterator

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


def _replay_visitor(db: MemDb) -> Callable[[int, int, int], None]:
    def visit(key: int, offset: int, size: int) -> None:
        if offset > 0 and not size_is_deleted(size):
            db.set(key, offset, size)
        else:
            db.delete(key)

    return visit


class AppendIndex:
    """Live append-only .idx writer backing an open volume, over a
    ``MemDb`` (the JAX package's ``kind="memory"``, the only kind ported)."""

    def __init__(self, idx_path: str | os.PathLike, offset_width: int = OFFSET_SIZE):
        self.path = os.fspath(idx_path)
        self.offset_width = offset_width
        self._truncate_torn_tail()
        self._f = open(self.path, "ab")
        self.db = MemDb()
        if os.path.getsize(self.path):
            with open(self.path, "rb") as f:
                walk_index_file(f, _replay_visitor(self.db), offset_width=self.offset_width)

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

    def put(self, key: int, offset: int, size: int) -> None:
        self._f.write(pack_index_entry(key, offset, size, self.offset_width))
        self._f.flush()  # .idx must be on disk for EC generate / crash rebuild
        self.db.set(key, offset, size)

    def delete(self, key: int) -> None:
        self._f.write(pack_index_entry(key, 0, TOMBSTONE_FILE_SIZE, self.offset_width))
        self._f.flush()
        self.db.delete(key)

    def get(self, key: int) -> NeedleValue | None:
        return self.db.get(key)

    def flush(self) -> None:
        self._f.flush()

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
