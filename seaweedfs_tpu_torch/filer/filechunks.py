"""Chunk-list interval resolution: the port's copy of
seaweedfs_tpu/filer/filechunks.py (reference weed/filer/filechunks.go).

A file's chunk list may contain overlapping writes; the visible view is
"latest modification wins" per byte range.  ``visible_intervals`` folds the
chunk list (sorted by modification time) into non-overlapping
:class:`VisibleInterval`\\ s, and ``read_chunk_views`` slices those against a
read range — the same two-step shape as the reference's
ReadResolvedChunks/ViewFromVisibleIntervals.
"""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.filer.entry import FileChunk


@dataclass
class VisibleInterval:
    start: int  # logical file offset, inclusive
    stop: int  # exclusive
    fid: str
    chunk_offset: int  # offset of ``start`` within the chunk's data
    modified_ts_ns: int


@dataclass
class ChunkView:
    fid: str
    offset_in_chunk: int
    size: int
    logical_offset: int


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def visible_intervals(chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Fold chunks (later mtime shadows earlier) into disjoint intervals."""
    intervals: list[VisibleInterval] = []
    for c in sorted(chunks, key=lambda c: (c.modified_ts_ns, c.fid)):
        lo, hi = c.offset, c.offset + c.size
        kept: list[VisibleInterval] = []
        for v in intervals:
            if v.stop <= lo or v.start >= hi:
                kept.append(v)
                continue
            if v.start < lo:  # left remnant survives
                kept.append(
                    VisibleInterval(
                        v.start, lo, v.fid, v.chunk_offset, v.modified_ts_ns
                    )
                )
            if v.stop > hi:  # right remnant survives
                kept.append(
                    VisibleInterval(
                        hi,
                        v.stop,
                        v.fid,
                        v.chunk_offset + (hi - v.start),
                        v.modified_ts_ns,
                    )
                )
        kept.append(VisibleInterval(lo, hi, c.fid, 0, c.modified_ts_ns))
        kept.sort(key=lambda v: v.start)
        intervals = kept
    return intervals


def read_chunk_views(
    intervals: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    """Slice the visible intervals against [offset, offset+size)."""
    stop = offset + size
    views: list[ChunkView] = []
    for v in intervals:
        if v.stop <= offset or v.start >= stop:
            continue
        lo = max(v.start, offset)
        hi = min(v.stop, stop)
        views.append(
            ChunkView(
                fid=v.fid,
                offset_in_chunk=v.chunk_offset + (lo - v.start),
                size=hi - lo,
                logical_offset=lo,
            )
        )
    return views
