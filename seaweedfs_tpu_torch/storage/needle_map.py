"""Needle map: id -> (offset, size) index replayed from an .idx log.

The port's copy of the part of seaweedfs_tpu/storage/needle_map.py that the
EC encoder needs: ``NeedleValue``, ``walk_index_file`` and ``MemDb``.  The
.idx file is an append-only log of 16-byte entries (same layout as the
reference's, weed/storage/needle_map/needle_value.go ToBytes); a deletion
appends an entry with zero offset and tombstone size.
"""

from __future__ import annotations

import io
import logging
import os
from dataclasses import dataclass
from typing import Callable, Iterator

from seaweedfs_tpu_torch.storage.types import (
    OFFSET_SIZE,
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

    @classmethod
    def load_from_idx(
        cls, idx_path: str | os.PathLike, offset_width: int = OFFSET_SIZE,
        strict: bool = False,
    ) -> "MemDb":
        """``strict`` raises on a torn tail instead of tolerating it —
        pass it when the loaded view seeds a sealed artifact (EC encode)
        where a silently-dropped entry would become silent data loss."""
        db = cls()

        def visit(key: int, offset: int, size: int) -> None:
            if offset > 0 and not size_is_deleted(size):
                db.set(key, offset, size)
            else:
                db.delete(key)

        with open(idx_path, "rb") as f:
            walk_index_file(f, visit, offset_width=offset_width, strict=strict)
        return db
