"""RFC 7233 single-range parsing for the volume server's HTTP reads: the
port's copy of seaweedfs_tpu/util/http_range.py (reference weed/util/http/
range handling)."""

from __future__ import annotations


class RangeNotSatisfiable(ValueError):
    """Maps to HTTP 416 with ``Content-Range: bytes */size``."""

    def __init__(self, size: int):
        super().__init__(f"range not satisfiable for size {size}")
        self.size = size


def parse_range(header: str | None, size: int) -> tuple[int, int] | None:
    """Parse a ``Range`` header against a body of ``size`` bytes.

    Returns an inclusive ``(lo, hi)`` pair, or ``None`` when the header is
    absent, syntactically invalid, or multi-range (per RFC 7233 leniency the
    caller then serves the full body with 200).  Raises
    :class:`RangeNotSatisfiable` for well-formed but unsatisfiable ranges.
    """
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes=") :].strip()
    if "," in spec:  # multi-range unsupported: fall back to full body
        return None
    lo_s, sep, hi_s = spec.partition("-")
    if not sep:
        return None
    try:
        lo = int(lo_s) if lo_s else None
        hi = int(hi_s) if hi_s else None
    except ValueError:  # plain parse failure, not RangeNotSatisfiable
        return None
    if lo is None:
        if hi is None:
            return None
        if hi <= 0 or size == 0:  # suffix form "bytes=-N"
            raise RangeNotSatisfiable(size)
        return max(0, size - hi), size - 1
    if hi is None:
        hi = size - 1
    elif hi < lo:  # "bytes=5-3": syntactically invalid spec — ignore header
        return None
    if lo >= size:
        raise RangeNotSatisfiable(size)
    return lo, min(hi, size - 1)
