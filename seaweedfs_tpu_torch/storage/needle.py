"""Needle: one stored blob and its on-disk record layout (the port's copy of
seaweedfs_tpu/storage/needle.py, with the port's own CRC32C).

Record layout (interoperable with the reference formats; structure per
weed/storage/needle/needle.go:25-46 and the version-2/3 write/read paths
needle_write_v{2,3}.go / needle_read.go):

  header   cookie(4BE) id(8BE) size(4BE)          -- size == body "Size" field
  body v2+ data_size(4BE) data flags(1)
           [name_size(1) name]  [mime_size(1) mime]
           [last_modified(5BE)] [ttl(2)] [pairs_size(2BE) pairs]
  tail     crc32c(4BE) [append_at_ns(8BE) v3] padding-to-8

The `size` header field counts the body bytes from data_size through pairs
(zero when there is no data); the .idx entry stores that same value.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from seaweedfs_tpu_torch.storage.types import (
    COOKIE_SIZE,
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_ID_SIZE,
    TIMESTAMP_SIZE,
    Version,
    get_actual_size,
    needle_body_length,
    padding_length,
)
from seaweedfs_tpu_torch.util.crc32c import crc32c

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2


class NeedleError(Exception):
    pass


class CookieMismatch(NeedleError):
    pass


class CrcMismatch(NeedleError):
    pass


@dataclass
class Needle:
    id: int = 0
    cookie: int = 0
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0
    ttl: bytes = b"\x00\x00"  # (count, unit) — raw 2-byte encoding
    checksum: int = 0
    append_at_ns: int = 0
    size: int = 0  # body "Size" header field; computed on serialize

    # -- flags -------------------------------------------------------------

    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set(self, flag: int) -> None:
        self.flags |= flag

    @property
    def is_chunk_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    # -- serialization -----------------------------------------------------

    def _computed_size(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + len(self.name)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: Version = Version.V3) -> bytes:
        """Full on-disk record including checksum, timestamp and padding."""
        if version == Version.V1:
            return self._to_bytes_v1()
        if len(self.name) > 255 or len(self.mime) > 255 or len(self.pairs) > 65535:
            raise NeedleError("name/mime/pairs exceed field limits")
        self.size = self._computed_size()
        self.checksum = crc32c(self.data)
        out = bytearray()
        out += self.cookie.to_bytes(COOKIE_SIZE, "big")
        out += self.id.to_bytes(NEEDLE_ID_SIZE, "big")
        out += self.size.to_bytes(4, "big")
        if self.data:
            out += len(self.data).to_bytes(4, "big")
            out += self.data
            out += bytes([self.flags])
            if self.has(FLAG_HAS_NAME):
                out += bytes([len(self.name)]) + self.name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime)]) + self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += self.last_modified.to_bytes(8, "big")[-LAST_MODIFIED_BYTES:]
            if self.has(FLAG_HAS_TTL):
                out += self.ttl[:TTL_BYTES].ljust(TTL_BYTES, b"\x00")
            if self.has(FLAG_HAS_PAIRS):
                out += len(self.pairs).to_bytes(2, "big") + self.pairs
        out += self.checksum.to_bytes(NEEDLE_CHECKSUM_SIZE, "big")
        if version == Version.V3:
            out += self.append_at_ns.to_bytes(TIMESTAMP_SIZE, "big")
        out += b"\x00" * padding_length(self.size, version)
        assert len(out) == get_actual_size(self.size, version)
        return bytes(out)

    def _to_bytes_v1(self) -> bytes:
        self.size = len(self.data)
        self.checksum = crc32c(self.data)
        out = bytearray()
        out += self.cookie.to_bytes(COOKIE_SIZE, "big")
        out += self.id.to_bytes(NEEDLE_ID_SIZE, "big")
        out += self.size.to_bytes(4, "big")
        out += self.data
        out += self.checksum.to_bytes(NEEDLE_CHECKSUM_SIZE, "big")
        out += b"\x00" * padding_length(self.size, Version.V1)
        return bytes(out)

    # -- parsing -----------------------------------------------------------

    @staticmethod
    def parse_header(buf: bytes) -> "Needle":
        n = Needle()
        n.cookie = int.from_bytes(buf[0:COOKIE_SIZE], "big")
        n.id = int.from_bytes(buf[COOKIE_SIZE : COOKIE_SIZE + NEEDLE_ID_SIZE], "big")
        raw = int.from_bytes(buf[COOKIE_SIZE + NEEDLE_ID_SIZE : NEEDLE_HEADER_SIZE], "big")
        n.size = raw - (1 << 32) if raw >= (1 << 31) else raw
        return n

    @classmethod
    def from_bytes(
        cls, buf: bytes, version: Version = Version.V3, verify_crc: bool = True
    ) -> "Needle":
        """Parse a full record produced by to_bytes / the reference writer."""
        n = cls.parse_header(buf)
        body = buf[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + n.size]
        if version == Version.V1:
            n.data = bytes(body)
        elif n.size > 0:
            idx = 0
            data_size = int.from_bytes(body[idx : idx + 4], "big")
            idx += 4
            n.data = bytes(body[idx : idx + data_size])
            idx += data_size
            if idx < len(body):
                n.flags = body[idx]
                idx += 1
            if idx < len(body) and n.has(FLAG_HAS_NAME):
                ln = body[idx]
                n.name = bytes(body[idx + 1 : idx + 1 + ln])
                idx += 1 + ln
            if idx < len(body) and n.has(FLAG_HAS_MIME):
                ln = body[idx]
                n.mime = bytes(body[idx + 1 : idx + 1 + ln])
                idx += 1 + ln
            if idx < len(body) and n.has(FLAG_HAS_LAST_MODIFIED):
                n.last_modified = int.from_bytes(
                    body[idx : idx + LAST_MODIFIED_BYTES], "big"
                )
                idx += LAST_MODIFIED_BYTES
            if idx < len(body) and n.has(FLAG_HAS_TTL):
                n.ttl = bytes(body[idx : idx + TTL_BYTES])
                idx += TTL_BYTES
            if idx < len(body) and n.has(FLAG_HAS_PAIRS):
                ln = int.from_bytes(body[idx : idx + 2], "big")
                n.pairs = bytes(body[idx + 2 : idx + 2 + ln])
                idx += 2 + ln
        tail = buf[NEEDLE_HEADER_SIZE + max(n.size, 0) :]
        n.checksum = int.from_bytes(tail[:NEEDLE_CHECKSUM_SIZE], "big")
        if version == Version.V3 and len(tail) >= NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE:
            n.append_at_ns = int.from_bytes(
                tail[NEEDLE_CHECKSUM_SIZE : NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE],
                "big",
            )
        if verify_crc and version != Version.V1 and n.data:
            if crc32c(n.data) != n.checksum:
                raise CrcMismatch(
                    f"needle {n.id:x} crc mismatch: stored {n.checksum:#x}"
                )
        return n

    def disk_size(self, version: Version = Version.V3) -> int:
        return get_actual_size(self._computed_size(), version)


def new_needle(
    needle_id: int,
    cookie: int,
    data: bytes,
    name: bytes = b"",
    mime: bytes = b"",
    last_modified: int | None = None,
) -> Needle:
    n = Needle(id=needle_id, cookie=cookie, data=data)
    if name:
        n.name = name
        n.set(FLAG_HAS_NAME)
    if mime:
        n.mime = mime
        n.set(FLAG_HAS_MIME)
    n.last_modified = (
        int(time.time()) if last_modified is None else last_modified
    )
    n.set(FLAG_HAS_LAST_MODIFIED)
    return n


def body_length(needle_size: int, version: Version) -> int:
    return needle_body_length(needle_size, version)
