"""Volume super block: the first 8 bytes of every .dat file.

The port's copy of seaweedfs_tpu/storage/super_block.py, with its
replica-placement codes and the TTL wire format that a mounted volume's
heartbeat reports.

Layout (same as the reference's, weed/storage/super_block/super_block.go):
byte 0 = needle version, byte 1 = replica placement code, bytes 2-3 = TTL,
bytes 4-5 = compaction revision (BE), bytes 6-7 = extra size (a 2-byte BE
count of trailing SuperBlockExtra bytes, rarely nonzero).  Our extension:
bytes 6-7 == [5, 0xFF] marks a 5-byte-index-offset volume (8TB cap).
The pair deliberately decodes as the implausible extra size 0x05FF so a
reference volume carrying real extra data is never misread as width-5
(any other 6-7 value means width 4, extra ignored, as before).  Width-5
volumes are ours alone — the reference expresses this as its
5BytesOffset build flavor, which cannot read a 4-byte build's volumes
either.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage.types import CURRENT_VERSION, Version

SUPER_BLOCK_SIZE = 8


@dataclass
class ReplicaPlacement:
    """xyz code: x = other DCs, y = other racks, z = other servers."""

    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"invalid replica placement {s!r}")
        return cls(diff_dc=int(s[0]), diff_rack=int(s[1]), same_rack=int(s[2]))

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(
            diff_dc=b // 100, diff_rack=(b // 10) % 10, same_rack=b % 10
        )

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.same_rack + self.diff_rack + self.diff_dc + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


# TTL wire format (2 bytes: count + unit), matching the reference's
# needle/volume TTL encoding (weed/storage/needle/volume_ttl.go)
_TTL_UNITS = [
    (0, 0),  # empty
    (1, 60),  # minute
    (2, 3600),  # hour
    (3, 86400),  # day
    (4, 7 * 86400),  # week
    (5, 30 * 86400),  # month
    (6, 365 * 86400),  # year
]


def ttl_from_seconds(seconds: int) -> bytes:
    if seconds <= 0:
        return b"\x00\x00"
    if seconds < 60:
        # the smallest wire unit is the minute: round sub-minute TTLs up
        return bytes([1, 1])
    for code, unit_sec in reversed(_TTL_UNITS[1:]):
        if seconds >= unit_sec and seconds // unit_sec <= 255:
            count = -(-seconds // unit_sec)  # round up within the unit
            if count <= 255:
                return bytes([count, code])
    return bytes([255, 6])  # cap at 255 years


def ttl_to_seconds(ttl: bytes) -> int:
    if len(ttl) < 2 or ttl[0] == 0:
        return 0
    for code, unit_sec in _TTL_UNITS:
        if code == ttl[1]:
            return ttl[0] * unit_sec
    return 0


@dataclass
class SuperBlock:
    version: Version = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: bytes = b"\x00\x00"
    compaction_revision: int = 0
    offset_width: int = 4  # index offset bytes: 4 (32GB cap) or 5 (8TB)

    def to_bytes(self) -> bytes:
        out = bytearray(SUPER_BLOCK_SIZE)
        out[0] = int(self.version)
        out[1] = self.replica_placement.to_byte()
        out[2:4] = self.ttl[:2].ljust(2, b"\x00")
        out[4:6] = self.compaction_revision.to_bytes(2, "big")
        if self.offset_width == 5:
            out[6], out[7] = 5, 0xFF  # width marker (see module docstring)
        elif self.offset_width != 4:
            raise ValueError(f"unsupported index offset width {self.offset_width}")
        return bytes(out)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        version = Version(b[0])
        return cls(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=bytes(b[2:4]),
            compaction_revision=int.from_bytes(b[4:6], "big"),
            offset_width=5 if b[6] == 5 and b[7] == 0xFF else 4,
        )
