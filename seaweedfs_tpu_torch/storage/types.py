"""Core on-disk scalar types and constants of the needle store.

The port's copy of the index-facing part of seaweedfs_tpu/storage/types.py:
sizes, the offset encoding, index entries and a needle record's size on
disk (what the EC decoder needs to recover a .dat's length).

Byte-layout contract with the reference formats (so volumes and indexes
interoperate): sizes/offsets per weed/storage/types/needle_types.go:33-42,
4-byte big-endian offsets stored in units of 8-byte padding
(weed/storage/types/offset_4bytes.go), 16-byte index entries
(NeedleIdSize + OffsetSize + SizeSize), tombstone size = -1.

Offset width is a per-volume property here (recorded in the superblock),
not the compile-time build flavor the reference uses: a width-5 volume
stores 17-byte index entries whose offset field matches the reference's
5BytesOffset build (weed/storage/types/offset_5bytes.go:19-25 — 4 BE
bytes of the low 32 bits, then the high byte) and raises the volume size
cap from 32GB to 8TB.
"""

from __future__ import annotations

import struct
from enum import IntEnum

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4  # width-4 volumes (the reference-interop default)
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
TOMBSTONE_FILE_SIZE = -1  # int32 sentinel in idx/ecx entries

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I32 = struct.Struct(">i")


class Version(IntEnum):
    V1 = 1
    V2 = 2
    V3 = 3


CURRENT_VERSION = Version.V3


def index_entry_size(offset_width: int = OFFSET_SIZE) -> int:
    """Bytes per .idx/.ecx entry for a volume of this offset width."""
    return NEEDLE_ID_SIZE + offset_width + SIZE_SIZE


def max_volume_size(offset_width: int = OFFSET_SIZE) -> int:
    """Hard .dat size cap: 2^(8*width) stored units of 8 bytes
    (32GB at width 4, 8TB at width 5 — offset_5bytes.go
    MaxPossibleVolumeSize)."""
    return (1 << (8 * offset_width)) * NEEDLE_PADDING_SIZE


def offset_to_bytes(actual_offset: int, offset_width: int = OFFSET_SIZE) -> bytes:
    """Actual byte offset (8-aligned) -> stored offset bytes.

    Width 4: big-endian uint32 of offset/8.  Width 5: the same 4 BE bytes
    of the low 32 bits followed by the high byte (reference
    offset_5bytes.go OffsetToBytes order)."""
    if actual_offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {actual_offset} not {NEEDLE_PADDING_SIZE}-aligned")
    stored = actual_offset // NEEDLE_PADDING_SIZE
    if stored >> (8 * offset_width):
        raise ValueError(
            f"offset {actual_offset} exceeds {offset_width}-byte stored range"
        )
    low = _U32.pack(stored & 0xFFFFFFFF)
    if offset_width == 4:
        return low
    return low + (stored >> 32).to_bytes(offset_width - 4, "little")


def bytes_to_offset(b: bytes) -> int:
    """Stored offset bytes (width = len(b)) -> actual byte offset."""
    stored = _U32.unpack_from(b, 0)[0]
    if len(b) > 4:
        stored |= int.from_bytes(b[4:], "little") << 32
    return stored * NEEDLE_PADDING_SIZE


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def padding_length(needle_size: int, version: Version) -> int:
    tail = NEEDLE_CHECKSUM_SIZE + (TIMESTAMP_SIZE if version == Version.V3 else 0)
    return NEEDLE_PADDING_SIZE - (
        (NEEDLE_HEADER_SIZE + needle_size + tail) % NEEDLE_PADDING_SIZE
    )


def needle_body_length(needle_size: int, version: Version) -> int:
    tail = NEEDLE_CHECKSUM_SIZE + (TIMESTAMP_SIZE if version == Version.V3 else 0)
    return needle_size + tail + padding_length(needle_size, version)


def get_actual_size(needle_size: int, version: Version) -> int:
    """Total bytes a needle record occupies on disk (header + body + pad)."""
    return NEEDLE_HEADER_SIZE + needle_body_length(needle_size, version)


def pack_index_entry(
    needle_id: int, actual_offset: int, size: int,
    offset_width: int = OFFSET_SIZE,
) -> bytes:
    """One .idx/.ecx entry: id(8BE) + offset/8(width B) + size(4BE)."""
    return (
        _U64.pack(needle_id)
        + offset_to_bytes(actual_offset, offset_width)
        + _I32.pack(size)
    )


def unpack_index_entry(b: bytes) -> tuple[int, int, int]:
    """One entry (width = len(b) - 12) -> (needle_id, actual_offset,
    size); size may be tombstone."""
    needle_id = _U64.unpack_from(b, 0)[0]
    offset = bytes_to_offset(b[NEEDLE_ID_SIZE:-SIZE_SIZE])
    size = _I32.unpack_from(b, len(b) - SIZE_SIZE)[0]
    return needle_id, offset, size
