"""Write-back page cache for one open file.

Counterpart of the reference's weed/mount/page_writer/ (dirty pages as
interval lists, uploaded as chunks on flush): writes land in merged
in-memory intervals; reads overlay them on the committed chunks
(read-your-writes before any flush); flush uploads each dirty interval
as chunk-size pieces through the master and returns the FileChunk
records to splice into the entry.

The port's copy of seaweedfs_tpu/mount/page_writer.py.
"""

from __future__ import annotations

import hashlib
import time

from seaweedfs_tpu_torch.filer.entry import FileChunk


class PageWriter:
    def __init__(self, chunk_size: int = 4 * 1024 * 1024):
        self.chunk_size = chunk_size
        # sorted, non-overlapping, non-adjacent dirty intervals
        self._dirty: list[tuple[int, bytearray]] = []

    # ---- write -----------------------------------------------------------
    def write(self, offset: int, data: bytes) -> None:
        if not data:
            return
        start, stop = offset, offset + len(data)
        merged_start, merged = start, bytearray(data)
        kept: list[tuple[int, bytearray]] = []
        for s, buf in self._dirty:
            e = s + len(buf)
            if e < merged_start or s > merged_start + len(merged):
                kept.append((s, buf))
                continue
            # overlap/adjacency: splice into one interval, new data wins
            new_start = min(s, merged_start)
            new_stop = max(e, merged_start + len(merged))
            out = bytearray(new_stop - new_start)
            out[s - new_start : e - new_start] = buf
            out[merged_start - new_start : merged_start - new_start + len(merged)] = merged
            merged_start, merged = new_start, out
        kept.append((merged_start, merged))
        kept.sort(key=lambda t: t[0])
        self._dirty = kept

    # ---- read overlay ----------------------------------------------------
    def overlay(self, base: bytes, offset: int) -> bytes:
        """Lay dirty intervals over ``base`` (which starts at ``offset``)."""
        if not self._dirty:
            return base
        out = bytearray(base)
        lo, hi = offset, offset + len(base)
        for s, buf in self._dirty:
            e = s + len(buf)
            if e <= lo or s >= hi:
                continue
            a, b = max(s, lo), min(e, hi)
            out[a - lo : b - lo] = buf[a - s : b - s]
        return bytes(out)

    def dirty_size_ceiling(self) -> int:
        """One past the highest dirty byte (0 if clean)."""
        dirty = self._dirty  # snapshot: getattr() reads without the file lock
        if not dirty:
            return 0
        s, buf = dirty[-1]
        return s + len(buf)

    @property
    def dirty(self) -> bool:
        return bool(self._dirty)

    def dirty_bytes(self) -> int:
        return sum(len(buf) for _s, buf in self._dirty)

    # ---- flush -----------------------------------------------------------
    def flush_to_chunks(self, upload_fn) -> list[FileChunk]:
        """Upload every dirty interval in chunk-size pieces;
        ``upload_fn(data) -> fid``.  Returns the new FileChunk records
        (later mtime than anything committed, so they shadow).

        The dirty intervals stay in place until :meth:`mark_clean` — a
        caller whose entry update fails after the upload must be able to
        retry without losing the buffered writes."""
        chunks: list[FileChunk] = []
        for s, buf in self._dirty:
            for i in range(0, len(buf), self.chunk_size):
                piece = bytes(buf[i : i + self.chunk_size])
                fid = upload_fn(piece)
                chunks.append(
                    FileChunk(
                        fid=fid,
                        offset=s + i,
                        size=len(piece),
                        modified_ts_ns=time.time_ns(),
                        e_tag=hashlib.md5(piece).hexdigest(),
                    )
                )
        return chunks

    def mark_clean(self) -> None:
        """Drop the dirty intervals — call only after the entry carrying
        the flushed chunks has been durably committed."""
        self._dirty = []
