"""Needle map: walk the (key, offset, size) entries of an .idx/.ecx file.

The port's copy of ``walk_index_file`` from seaweedfs_tpu/storage/
needle_map.py, which the EC decoder needs.  The .idx file is an
append-only log of 16-byte entries (same layout as the reference's,
weed/storage/needle_map/needle_value.go ToBytes); a deletion appends an
entry with zero offset and tombstone size.  (The encoder replays the log
in bulk: ec_encoder.write_sorted_ecx_file.)
"""

from __future__ import annotations

import io
import logging
from typing import Callable

from seaweedfs_tpu_torch.storage.types import OFFSET_SIZE, index_entry_size, unpack_index_entry

log = logging.getLogger(__name__)


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
