"""Durable metadata event log with segment rotation: the port's copy of
seaweedfs_tpu/filer/meta_log.py, whose segment files it reads and writes
byte for byte.

Counterpart of the reference's weed/filer/filer_notify.go (logFlush into
dated system-log files) + filer_notify_read.go (replaying persisted
segments for SubscribeMetadata readers that start in the past).  The
reference stores its log as chunked files inside the filer itself; here
the log is a directory of append-only segment files next to the filer
store — same durability, none of the self-recursion hazards.

Record framing: ``u32 length | length bytes of serialized MetadataEvent``.
Segments are named ``<first_ts_ns>.metalog`` so a reader seeking
``since_ts_ns`` can skip whole segments by filename.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Iterator

from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb

SEGMENT_BYTES = 8 * 1024 * 1024  # rotate segments at 8MB


class PersistentMetaLog:
    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._fh_size = 0

    # ---- write ----------------------------------------------------------
    def append(self, event: f_pb.MetadataEvent) -> None:
        blob = event.SerializeToString()
        rec = struct.pack("<I", len(blob)) + blob
        with self._lock:
            if self._fh is None or self._fh_size + len(rec) > SEGMENT_BYTES:
                self._rotate_locked(event.ts_ns)
            self._fh.write(rec)
            self._fh.flush()
            self._fh_size += len(rec)

    def _rotate_locked(self, first_ts_ns: int) -> None:
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.dir, f"{first_ts_ns:020d}.metalog")
        self._fh = open(path, "ab")
        self._fh_size = self._fh.tell()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # ---- read -----------------------------------------------------------
    def _segments(self) -> list[str]:
        return sorted(
            f for f in os.listdir(self.dir) if f.endswith(".metalog")
        )

    def read_since(self, since_ts_ns: int) -> Iterator[f_pb.MetadataEvent]:
        """Yield persisted events with ts_ns > since_ts_ns, in order."""
        segs = self._segments()
        # A segment may be skipped only if the NEXT segment also starts
        # at/before the cursor (every event in it is then ≤ since).
        for i, seg in enumerate(segs):
            if i + 1 < len(segs):
                next_first = int(segs[i + 1].split(".")[0])
                if next_first <= since_ts_ns:
                    continue
            yield from self._read_segment(os.path.join(self.dir, seg), since_ts_ns)

    def _read_segment(
        self, path: str, since_ts_ns: int
    ) -> Iterator[f_pb.MetadataEvent]:
        with open(path, "rb") as fh:
            while True:
                hdr = fh.read(4)
                if len(hdr) < 4:
                    return
                (length,) = struct.unpack("<I", hdr)
                blob = fh.read(length)
                if len(blob) < length:
                    return  # torn tail record from a crash — stop here
                ev = f_pb.MetadataEvent.FromString(blob)
                if ev.ts_ns > since_ts_ns:
                    yield ev
