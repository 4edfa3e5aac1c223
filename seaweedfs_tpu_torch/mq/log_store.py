"""Per-partition offset log: append-only segments + columnar tiering.

Counterpart of the reference's weed/mq/logstore/ (log files on disk;
log_to_parquet.go seals old segments into Parquet).  Here the sealed
tier is a columnar numpy archive (.npz of offset/ts arrays + packed
key/value bytes with boundary indexes) — the same "old data becomes
columns" design, in the array layout the rest of this framework speaks.

Segment framing: u32 record_len | u64 offset | s64 ts_ns | u32 klen |
key | value.  Segments are named by base offset; readers merge columnar
archives, sealed segments, and the live tail.

The port's copy of seaweedfs_tpu/mq/log_store.py.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Iterator

import numpy as np

_HDR = struct.Struct("<IQqI")
SEGMENT_BYTES = 8 * 1024 * 1024


class Message:
    __slots__ = ("offset", "ts_ns", "key", "value")

    def __init__(self, offset: int, ts_ns: int, key: bytes, value: bytes):
        self.offset = offset
        self.ts_ns = ts_ns
        self.key = key
        self.value = value


class PartitionLog:
    def __init__(self, dir_path: str, tier=None, tier_path: str = ""):
        """``tier``/``tier_path``: optional sealed-segment offload (a
        FilerSegmentTier + this partition's directory under its root).
        Archives uploaded there may be EVICTED from local disk; reads
        fetch them back on demand, and a fresh broker (empty local dir)
        recovers history straight from the tier."""
        self.dir = dir_path
        self.tier = tier
        self.tier_path = tier_path.strip("/")
        os.makedirs(dir_path, exist_ok=True)
        self._lock = threading.Lock()
        self.cond = threading.Condition(self._lock)
        self._fh = None
        self._fh_size = 0
        self._tier_cache: tuple[dict[str, int], float] | None = None
        self.next_offset = self._recover_next_offset()

    # ---- discovery -------------------------------------------------------
    def _segments(self) -> list[str]:
        return sorted(
            f for f in os.listdir(self.dir) if f.endswith(".log")
        )

    def _archives(self) -> list[str]:
        return sorted(
            f for f in os.listdir(self.dir) if f.endswith(".npz")
        )

    _TIER_TTL = 2.0

    def _tiered(self, fresh: bool = False) -> dict[str, int]:
        """{name: size} of archives in the filer tier (TTL-cached; the
        set only grows via the owner's seals, so staleness is benign for
        reads).  ``fresh`` forces a live listing and RAISES on failure —
        eviction must never trust a stale view (the cached entry could
        name an archive an operator has since deleted)."""
        if self.tier is None:
            return {}
        now = time.monotonic()
        cached = self._tier_cache
        if not fresh and cached is not None and now - cached[1] < self._TIER_TTL:
            return cached[0]
        try:
            names = {
                k: v
                for k, v in self.tier.list(self.tier_path).items()
                if k.endswith(".npz")
            }
        except OSError:
            if fresh:
                raise
            # tier unreachable: serve what's local rather than failing
            # reads
            names = cached[0] if cached is not None else {}
            self._tier_cache = (names, now - self._TIER_TTL + 0.5)
            return names
        self._tier_cache = (names, now)
        return names

    def _all_archives(self) -> list[str]:
        return sorted(set(self._archives()) | set(self._tiered()))

    def _ensure_local(self, name: str) -> str:
        """Local path of an archive, downloading from the tier when it
        was evicted (read-through)."""
        path = os.path.join(self.dir, name)
        if not os.path.exists(path) and self.tier is not None:
            self.tier.get(f"{self.tier_path}/{name}", path)
        return path

    def _recover_next_offset(self) -> int:
        last = 0
        for msg in self._read_segment_files(0):
            last = msg.offset + 1
        for name in self._archives():
            with np.load(os.path.join(self.dir, name)) as z:
                if len(z["offset"]):
                    last = max(last, int(z["offset"][-1]) + 1)
        # a fresh/rebuilt broker may have its whole history in the tier:
        # the newest tiered archive bounds the recovered offset
        tiered = sorted(set(self._tiered()) - set(self._archives()))
        if tiered and int(tiered[-1].split(".")[0]) >= last:
            with np.load(self._ensure_local(tiered[-1])) as z:
                if len(z["offset"]):
                    last = max(last, int(z["offset"][-1]) + 1)
        return last

    def earliest_offset(self) -> int:
        names = self._all_archives() + self._segments()
        if not names:
            return self.next_offset
        return int(names[0].split(".")[0])

    # ---- write -----------------------------------------------------------
    def append(self, key: bytes, value: bytes, ts_ns: int | None = None) -> int:
        return self.append_with_ts(key, value, ts_ns)[0]

    def append_with_ts(
        self, key: bytes, value: bytes, ts_ns: int | None = None
    ) -> tuple[int, int]:
        """Append; returns (offset, ts_ns) — replication needs the stamped
        timestamp so replicas store byte-identical records."""
        with self._lock:
            offset = self.next_offset
            ts = ts_ns if ts_ns is not None else time.time_ns()
            self._write_locked(offset, ts, key, value)
            return offset, ts

    def append_external(
        self, offset: int, ts_ns: int, key: bytes, value: bytes
    ) -> str:
        """Apply a record replicated from the partition owner at ITS
        offset.  Returns ``"applied"``, ``"duplicate"`` (offset already
        present — the caller may verify content to detect a split-brain
        double-ack), or ``"gap"`` (offset ahead of our tail; the caller
        reports ``next_offset`` so the owner backfills)."""
        with self._lock:
            if offset < self.next_offset:
                return "duplicate"  # retry/backfill overlap — or divergence
            if offset > self.next_offset:
                return "gap"  # refuse, ask for backfill
            self._write_locked(offset, ts_ns, key, value)
            return "applied"

    def _write_locked(
        self, offset: int, ts: int, key: bytes, value: bytes
    ) -> None:
        rec = _HDR.pack(len(key) + len(value), offset, ts, len(key)) + key + value
        if self._fh is None or self._fh_size + len(rec) > SEGMENT_BYTES:
            self._roll_locked(offset)
        self._fh.write(rec)
        self._fh.flush()
        self._fh_size += len(rec)
        self.next_offset = offset + 1
        self.cond.notify_all()

    def _roll_locked(self, base_offset: int) -> None:
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.dir, f"{base_offset:020d}.log")
        self._fh = open(path, "ab")
        self._fh_size = self._fh.tell()

    # ---- read ------------------------------------------------------------
    @staticmethod
    def _skip_by_name(names: list[str], start_offset: int) -> list[str]:
        """Drop files whose successor's base offset is <= start (every
        record in them precedes the cursor) — keeps tail re-reads O(tail),
        not O(partition)."""
        keep: list[str] = []
        for i, name in enumerate(names):
            if i + 1 < len(names):
                next_base = int(names[i + 1].split(".")[0])
                if next_base <= start_offset:
                    continue
            keep.append(name)
        return keep

    def _read_segment_files(
        self, start_offset: int, names: list[str] | None = None
    ) -> Iterator[Message]:
        names = self._segments() if names is None else names
        for name in self._skip_by_name(names, start_offset):
            path = os.path.join(self.dir, name)
            with open(path, "rb") as fh:
                while True:
                    hdr = fh.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    total, offset, ts, klen = _HDR.unpack(hdr)
                    body = fh.read(total)
                    if len(body) < total:
                        break  # torn tail from a crash
                    if offset >= start_offset:
                        yield Message(offset, ts, body[:klen], body[klen:])

    def _read_archives(
        self, start_offset: int, names: list[str] | None = None
    ) -> Iterator[Message]:
        names = self._all_archives() if names is None else names
        for name in self._skip_by_name(names, start_offset):
            path = self._ensure_local(name)
            with np.load(path) as z:
                offsets = z["offset"]
                if not len(offsets) or int(offsets[-1]) < start_offset:
                    continue
                ts = z["ts_ns"]
                kb, ki = z["key_bytes"].tobytes(), z["key_index"]
                vb, vi = z["value_bytes"].tobytes(), z["value_index"]
                lo = int(np.searchsorted(offsets, start_offset))
                for i in range(lo, len(offsets)):
                    yield Message(
                        int(offsets[i]),
                        int(ts[i]),
                        kb[ki[i] : ki[i + 1]],
                        vb[vi[i] : vi[i + 1]],
                    )

    def read(self, start_offset: int = 0) -> Iterator[Message]:
        """All stored messages with offset >= start, in offset order.

        Seal-safe: segments are listed BEFORE archives, so a concurrent
        seal either leaves the logs readable or removes them after the
        archive covering them is already in our list — and a log vanishing
        mid-read (FileNotFoundError) restarts from the cursor, where the
        new archive now serves the missing range.  Retries back off and
        give up after repeated attempts with NO cursor progress (a tier
        listing that names an unfetchable archive must not become a hot
        loop against the filer)."""
        cursor = start_offset
        stalls = 0
        while True:
            with self._lock:
                segments = self._segments()
                local_archives = self._archives()
            # the tier listing does network IO: never under the lock
            # (a slow filer would stall every publish to this partition)
            archives = sorted(set(local_archives) | set(self._tiered()))
            progressed_from = cursor
            try:
                for msg in self._read_archives(cursor, archives):
                    if msg.offset < cursor:
                        # replicas may hold archives whose ranges overlap
                        # the tier's (independent seal boundaries after an
                        # ownership change): never replay a duplicate
                        continue
                    yield msg
                    cursor = msg.offset + 1
                for msg in self._read_segment_files(cursor, segments):
                    if msg.offset < cursor:
                        continue
                    yield msg
                    cursor = msg.offset + 1
                return
            except FileNotFoundError:
                # seal moved files under us; resume at cursor
                stalls = 0 if cursor > progressed_from else stalls + 1
                if stalls >= 50:
                    raise  # listed-but-unfetchable: surface, don't spin
                time.sleep(0.05)
                continue

    def wait_for(self, offset: int, timeout: float = 0.5) -> bool:
        """Block until next_offset > offset (new data) or timeout."""
        with self._lock:
            if self.next_offset > offset:
                return True
            self.cond.wait(timeout)
            return self.next_offset > offset

    # ---- columnar tiering (the Parquet analogue) -------------------------
    def seal_to_columnar(self, keep_segments: int = 1, upload: bool = True) -> int:
        """Fold all but the newest ``keep_segments`` .log segments into one
        columnar archive; returns messages archived.

        Sealed segments are immutable (the active segment is always in
        the kept tail), so the scan and compression run without the lock —
        publishes never stall behind a seal.  Only the publish of the
        archive + removal of the logs mutates state, under the lock so
        readers' snapshots see either the logs or the archive.

        ``upload=False`` seals locally only — the broker passes it for
        partitions it does NOT own, so replicas (whose seal boundaries
        may differ) never overwrite the owner's tier archives."""
        with self._lock:
            segs = self._segments()
        keep = max(1, keep_segments)  # never touch the active segment
        to_seal = segs[:-keep]
        if not to_seal:
            return 0
        msgs: list[Message] = []
        for name in to_seal:
            path = os.path.join(self.dir, name)
            with open(path, "rb") as fh:
                while True:
                    hdr = fh.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    total, offset, ts, klen = _HDR.unpack(hdr)
                    body = fh.read(total)
                    if len(body) < total:
                        break
                    msgs.append(Message(offset, ts, body[:klen], body[klen:]))
        if not msgs:
            return 0
        key_index = np.zeros(len(msgs) + 1, dtype=np.int64)
        value_index = np.zeros(len(msgs) + 1, dtype=np.int64)
        for i, m in enumerate(msgs):
            key_index[i + 1] = key_index[i] + len(m.key)
            value_index[i + 1] = value_index[i] + len(m.value)
        base = msgs[0].offset
        out = os.path.join(self.dir, f"{base:020d}.npz")
        np.savez_compressed(
            out + ".tmp.npz",
            offset=np.array([m.offset for m in msgs], dtype=np.int64),
            ts_ns=np.array([m.ts_ns for m in msgs], dtype=np.int64),
            key_bytes=np.frombuffer(
                b"".join(m.key for m in msgs), dtype=np.uint8
            ),
            key_index=key_index,
            value_bytes=np.frombuffer(
                b"".join(m.value for m in msgs), dtype=np.uint8
            ),
            value_index=value_index,
        )
        with self._lock:
            os.replace(out + ".tmp.npz", out)
            for name in to_seal:
                os.remove(os.path.join(self.dir, name))
        if self.tier is not None and upload:
            # archives are immutable once published: the upload can run
            # after the lock drops.  A failed upload keeps the local copy
            # (eviction verifies against a fresh tier listing).  NEVER
            # overwrite an existing tier object — a same-name archive
            # with a different size means divergent seal boundaries
            # (e.g. an ownership change mid-history) and clobbering it
            # could orphan acked records the uploader doesn't hold.
            from seaweedfs_tpu_torch.util import wlog

            name = os.path.basename(out)
            try:
                existing = self._tiered(fresh=True).get(name)
                if existing is None:
                    self.tier.put(f"{self.tier_path}/{name}", out)
                    self._tier_cache = None  # listing changed
                elif existing != os.path.getsize(out):
                    wlog.warning(
                        "mq tier: NOT overwriting %s/%s (tier %d bytes, "
                        "local %d) — divergent seal boundaries; keeping "
                        "the local copy unevictable",
                        self.tier_path, name, existing,
                        os.path.getsize(out),
                    )
            except OSError as e:
                wlog.warning("mq tier upload %s failed: %s", name, e)
        return len(msgs)

    def evict_tiered(self) -> int:
        """Drop local copies of archives that are safely in the filer
        tier (size-verified against a fresh listing); reads fetch them
        back on demand.  Returns archives evicted — this is what bounds
        broker disks (reference: parquet lives in the filer, brokers
        keep only the live tail)."""
        if self.tier is None:
            return 0
        try:
            tiered = self._tiered(fresh=True)
        except OSError:
            return 0  # no fresh listing, no eviction — never trust cache
        evicted = 0
        for name in self._archives():
            path = os.path.join(self.dir, name)
            if tiered.get(name) == os.path.getsize(path):
                os.remove(path)
                evicted += 1
        return evicted

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
