"""Needle payload compression: the port's copy of
seaweedfs_tpu/storage/compression.py, byte for byte in what it produces.

Counterpart of the reference's upload-time gzip (weed/storage/needle/
needle_parse_upload.go:76-81 — compress when the content type is
gzippable AND gzip shrinks the payload by >10%) and read-time handling
(serve compressed to Accept-Encoding: gzip clients, else decompress).
gzip is the only format, as in the JAX package.
"""

from __future__ import annotations

import gzip

MIN_COMPRESS_SIZE = 128  # tiny payloads never win
# reference IsGzippableFileType (util/compression.go): textual types and
# formats that are not already entropy-coded
_GZIPPABLE_MIME_PREFIXES = ("text/",)
_GZIPPABLE_MIMES = {
    "application/json",
    "application/xml",
    "application/javascript",
    "application/x-javascript",
    "application/yaml",
    "application/x-ndjson",
    "image/svg+xml",
}
_INCOMPRESSIBLE_SUFFIXES = (
    ".gz", ".zst", ".zip", ".jpg", ".jpeg", ".png", ".webp", ".mp4",
    ".mp3", ".7z", ".br",
)
_GZIPPABLE_SUFFIXES = (
    ".txt", ".html", ".htm", ".css", ".js", ".json", ".xml", ".csv",
    ".md", ".log", ".yaml", ".yml", ".svg",
)


def is_gzippable(mime: str = "", name: str = "") -> bool:
    mime = (mime or "").split(";")[0].strip().lower()
    name = (name or "").lower()
    if name.endswith(_INCOMPRESSIBLE_SUFFIXES):
        return False
    if mime.startswith(_GZIPPABLE_MIME_PREFIXES) or mime in _GZIPPABLE_MIMES:
        return True
    return name.endswith(_GZIPPABLE_SUFFIXES)


def compress(data: bytes, level: int = 3) -> bytes:
    # mtime=0 keeps the output deterministic so independently compressing
    # replicas produce identical needle bytes (and CRCs)
    return gzip.compress(data, compresslevel=level, mtime=0)


def decompress(data: bytes) -> bytes:
    return gzip.decompress(data)


def maybe_compress(data: bytes, mime: str = "", name: str = "") -> bytes | None:
    """Returns the compressed payload when it's worth storing, else None
    (the reference's >10% shrink rule, needle_parse_upload.go:77)."""
    if len(data) < MIN_COMPRESS_SIZE or not is_gzippable(mime, name):
        return None
    packed = compress(data)
    if len(packed) * 10 < len(data) * 9:
        return packed
    return None
