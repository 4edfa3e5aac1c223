"""Append-only copy-on-write B+tree: a second independent ordered-KV
engine beside util/lsm.py.  The port's copy of seaweedfs_tpu/util/btree.py:
its frames and node layouts are the same bytes, so each package opens the
other's ``.btree`` file.

Counterpart of the reference filer's bolt/leveldb-family embedded
stores (weed/filer/leveldb*, the boltdb-backed stores): one file, full
ordered scans, crash safety without a WAL.  The design is the
couchstore/LMDB-append lineage rather than an LSM:

  * every mutation copies the leaf→root path and APPENDS the new nodes,
    then appends a ROOT frame; nothing is ever overwritten;
  * a crash can only produce a torn tail — recovery replays the frame
    stream and adopts the last ROOT whose CRC checks out, so commits
    are atomic by construction (no fsync ordering subtleties);
  * readers traverse from the in-memory root; scans are in-order tree
    walks (no tombstones, no merge iterators — unlike the LSM);
  * dead space from superseded nodes is reclaimed by `compact()`
    (rewrite live tree into a fresh file), triggered automatically when
    the dead ratio crosses a threshold at close/commit time.

Frames: [u8 kind][u32 len][payload][u32 crc32].  Node payloads are a
compact binary layout (no pickle — the file must be readable by any
future implementation).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from bisect import bisect_left, bisect_right
from typing import Iterator

_HDR = struct.Struct("<BI")
_CRC = struct.Struct("<I")
_ROOT = struct.Struct("<QQQ")  # root offset, live bytes, item count

KIND_LEAF = 1
KIND_BRANCH = 2
KIND_ROOT = 3

FANOUT = 64  # max entries per node before split
_EMPTY = 0xFFFFFFFFFFFFFFFF  # root offset sentinel for "empty tree"


def _pack_leaf(items: list[tuple[bytes, bytes]]) -> bytes:
    out = [struct.pack("<I", len(items))]
    for k, v in items:
        out.append(struct.pack("<II", len(k), len(v)))
        out.append(k)
        out.append(v)
    return b"".join(out)


def _unpack_leaf(buf: bytes) -> list[tuple[bytes, bytes]]:
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    items = []
    for _ in range(n):
        kl, vl = struct.unpack_from("<II", buf, off)
        off += 8
        items.append((buf[off : off + kl], buf[off + kl : off + kl + vl]))
        off += kl + vl
    return items


def _pack_branch(keys: list[bytes], children: list[int]) -> bytes:
    out = [struct.pack("<I", len(children))]
    for c in children:
        out.append(struct.pack("<Q", c))
    for k in keys:
        out.append(struct.pack("<I", len(k)))
        out.append(k)
    return b"".join(out)


def _unpack_branch(buf: bytes) -> tuple[list[bytes], list[int]]:
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    children = []
    for _ in range(n):
        (c,) = struct.unpack_from("<Q", buf, off)
        children.append(c)
        off += 8
    keys = []
    for _ in range(n - 1):
        (kl,) = struct.unpack_from("<I", buf, off)
        off += 4
        keys.append(buf[off : off + kl])
        off += kl
    return keys, children


class BTreeStore:
    """Single-file ordered KV with the put/get/delete/scan contract the
    filer's LevelDb-style adapters consume (same API as util/lsm)."""

    def __init__(
        self,
        path: str,
        compact_dead_ratio: float = 0.6,
        compact_min_bytes: int = 1 << 20,
    ):
        if os.path.isdir(path):
            path = os.path.join(path, "filer.btree")
        self.path = path
        self.compact_dead_ratio = compact_dead_ratio
        self.compact_min_bytes = compact_min_bytes
        self._io_lock = threading.RLock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a+b")
        self._root = _EMPTY
        self._live = 0
        self._count = 0
        # generation bumps on compact: node offsets are only meaningful
        # within one file generation, so the cache keys on (gen, off)
        # and in-flight scans pin the fd they started on
        self._gen = 0
        self._retired: list = []  # old file handles kept for live scans
        self._cache: dict[tuple[int, int], tuple] = {}
        self._recover()

    # ---- framing ---------------------------------------------------------
    def _append_frame(self, kind: int, payload: bytes) -> int:
        off = self._fh.seek(0, os.SEEK_END)
        crc = zlib.crc32(payload)
        self._fh.write(_HDR.pack(kind, len(payload)) + payload + _CRC.pack(crc))
        return off

    def _read_frame(self, off: int, fd: int | None = None) -> tuple[int, bytes] | None:
        """pread-based (no shared seek state): readers never race the
        appender's file position, and scans read from the fd they
        captured even while compact() swaps the live handle."""
        if fd is None:
            fd = self._fh.fileno()
        hdr = os.pread(fd, _HDR.size, off)
        if len(hdr) < _HDR.size:
            return None
        kind, ln = _HDR.unpack(hdr)
        rest = os.pread(fd, ln + _CRC.size, off + _HDR.size)
        if len(rest) < ln + _CRC.size:
            return None
        payload, crc_raw = rest[:ln], rest[ln:]
        if zlib.crc32(payload) != _CRC.unpack(crc_raw)[0]:
            return None
        return kind, payload

    def _recover(self) -> None:
        """Adopt the last valid ROOT; truncate any torn tail after it."""
        off = 0
        last_good_end = 0
        size = os.path.getsize(self.path)
        while off < size:
            frame = self._read_frame(off)
            if frame is None:
                break  # torn tail from a crash: everything after is dead
            kind, payload = frame
            end = off + _HDR.size + len(payload) + _CRC.size
            if kind == KIND_ROOT and len(payload) == _ROOT.size:
                self._root, self._live, self._count = _ROOT.unpack(payload)
                last_good_end = end
            off = end
        if last_good_end < size:
            # torn tail past the last committed root: discard it — those
            # frames were never acknowledged by a commit
            self._fh.truncate(last_good_end)

    def _node(self, off: int, gen: int | None = None, fd: int | None = None):
        if gen is None:
            gen = self._gen
        key = (gen, off)
        node = self._cache.get(key)
        if node is not None:
            return node
        frame = self._read_frame(off, fd)
        if frame is None:
            raise IOError(f"btree: unreadable node at {off}")
        kind, payload = frame
        if kind == KIND_LEAF:
            node = ("leaf", _unpack_leaf(payload))
        else:
            node = ("branch", *_unpack_branch(payload))
        with self._io_lock:
            if len(self._cache) > 4096:
                self._cache.clear()
            self._cache[key] = node
        return node

    def _write_leaf_locked(self, items) -> int:
        off = self._append_frame(KIND_LEAF, _pack_leaf(items))
        self._cache[(self._gen, off)] = ("leaf", items)
        return off

    def _write_branch_locked(self, keys, children) -> int:
        off = self._append_frame(KIND_BRANCH, _pack_branch(keys, children))
        self._cache[(self._gen, off)] = ("branch", keys, children)
        return off

    def _commit_locked(self, root: int, live_delta: int, count_delta: int) -> None:
        self._root = root
        self._live += live_delta
        self._count += count_delta
        self._append_frame(
            KIND_ROOT, _ROOT.pack(self._root, self._live, self._count)
        )
        self._fh.flush()

    # ---- mutation --------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        with self._io_lock:
            if self._root == _EMPTY:
                root = self._write_leaf_locked([(key, value)])
                self._commit_locked(root, len(key) + len(value), 1)
                return
            result = self._insert(self._root, key, value)
            if len(result) == 1:
                root = result[0][1]
            else:  # root split
                root = self._write_branch_locked(
                    [result[1][0]], [result[0][1], result[1][1]]
                )
            replaced, size_delta = self._last_put_info
            self._commit_locked(root, size_delta, 0 if replaced else 1)
            self._maybe_compact()

    def _insert(self, off: int, key: bytes, value: bytes):
        """Returns [(first_key, new_off)] or two pairs after a split."""
        node = self._node(off)
        if node[0] == "leaf":
            items = list(node[1])
            keys = [k for k, _ in items]
            i = bisect_left(keys, key)
            if i < len(items) and items[i][0] == key:
                old = items[i][1]
                self._last_put_info = (True, len(value) - len(old))
                items[i] = (key, value)
            else:
                self._last_put_info = (False, len(key) + len(value))
                items.insert(i, (key, value))
            if len(items) <= FANOUT:
                return [(items[0][0], self._write_leaf_locked(items))]
            mid = len(items) // 2
            left, right = items[:mid], items[mid:]
            return [
                (left[0][0], self._write_leaf_locked(left)),
                (right[0][0], self._write_leaf_locked(right)),
            ]
        _, keys, children = node
        i = bisect_right(keys, key)
        result = self._insert(children[i], key, value)
        new_keys = list(keys)
        new_children = list(children)
        new_children[i] = result[0][1]
        if len(result) == 2:
            new_keys.insert(i, result[1][0])
            new_children.insert(i + 1, result[1][1])
        if len(new_children) <= FANOUT:
            return [(key, self._write_branch_locked(new_keys, new_children))]
        mid = len(new_children) // 2
        sep = new_keys[mid - 1]
        l_off = self._write_branch_locked(new_keys[: mid - 1], new_children[:mid])
        r_off = self._write_branch_locked(new_keys[mid:], new_children[mid:])
        return [(key, l_off), (sep, r_off)]

    def delete(self, key: bytes) -> None:
        """COW delete; underfull nodes are tolerated (compaction rebuilds
        a tight tree — simpler than rebalancing and crash-safe the same
        way)."""
        with self._io_lock:
            if self._root == _EMPTY:
                return
            new_off, removed, freed = self._delete(self._root, key)
            if not removed:
                return
            if new_off is None:
                self._commit_locked(_EMPTY, -freed, -1)
            else:
                self._commit_locked(new_off, -freed, -1)
            self._maybe_compact()

    def _delete(self, off: int, key: bytes):
        node = self._node(off)
        if node[0] == "leaf":
            items = list(node[1])
            keys = [k for k, _ in items]
            i = bisect_left(keys, key)
            if i >= len(items) or items[i][0] != key:
                return off, False, 0
            freed = len(key) + len(items[i][1])
            del items[i]
            if not items:
                return None, True, freed
            return self._write_leaf_locked(items), True, freed
        _, keys, children = node
        i = bisect_right(keys, key)
        new_child, removed, freed = self._delete(children[i], key)
        if not removed:
            return off, False, 0
        new_keys = list(keys)
        new_children = list(children)
        if new_child is None:
            del new_children[i]
            if new_keys:
                del new_keys[max(0, i - 1)]
            if len(new_children) == 1:
                return new_children[0], True, freed
            if not new_children:
                return None, True, freed
        else:
            new_children[i] = new_child
        return self._write_branch_locked(new_keys, new_children), True, freed

    # ---- read ------------------------------------------------------------
    def get(self, key: bytes) -> bytes | None:
        with self._io_lock:
            off = self._root
            if off == _EMPTY:
                return None
            while True:
                node = self._node(off)
                if node[0] == "leaf":
                    items = node[1]
                    keys = [k for k, _ in items]
                    i = bisect_left(keys, key)
                    if i < len(items) and items[i][0] == key:
                        return items[i][1]
                    return None
                _, keys, children = node
                off = children[bisect_right(keys, key)]

    def scan(
        self, start: bytes = b"", stop: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        """In-order (key, value) pairs with start <= key < stop.

        Snapshot semantics: the scan pins (root, generation, fd) at call
        time; COW nodes are immutable and reads are positionless preads,
        so concurrent put/delete never disturb it, and a concurrent
        compact() retires — but does not close — the old handle until
        close()."""
        with self._io_lock:
            root = self._root
            gen = self._gen
            fd = self._fh.fileno()
        if root == _EMPTY:
            return
        yield from self._scan_node(root, start, stop, gen, fd)

    def _scan_node(self, off, start, stop, gen=None, fd=None):
        node = self._node(off, gen, fd)
        if node[0] == "leaf":
            for k, v in node[1]:
                if k < start:
                    continue
                if stop is not None and k >= stop:
                    return
                yield k, v
            return
        _, keys, children = node
        first = bisect_right(keys, start)
        for i in range(first, len(children)):
            if stop is not None and i > first and i - 1 < len(keys) and keys[i - 1] >= stop:
                return
            yield from self._scan_node(children[i], start, stop, gen, fd)

    # ---- maintenance -----------------------------------------------------
    def _maybe_compact(self) -> None:
        size = self._fh.tell()
        if size < self.compact_min_bytes:
            return
        if self._live <= 0 or (size - self._live) / size >= self.compact_dead_ratio:
            self.compact()

    def compact(self) -> None:
        """Rewrite the live tree into a fresh file (atomic replace)."""
        with self._io_lock:
            items = list(self.scan(b""))
            tmp_path = self.path + ".compact"
            old_fh = self._fh
            self._fh = open(tmp_path, "w+b")
            # bump the generation BEFORE writing the new tree: _bulk_load
            # caches its nodes under self._gen, and a scan pinned to the
            # old generation must never see new-file nodes at colliding
            # offsets (cache keys are (gen, off))
            self._gen += 1
            self._cache.clear()
            try:
                self._root = _EMPTY
                self._live = 0
                self._count = 0
                if items:
                    root, live = self._bulk_load(items)
                    self._commit_locked(root, live, len(items))
                else:
                    self._append_frame(
                        KIND_ROOT, _ROOT.pack(_EMPTY, 0, 0)
                    )
                    self._fh.flush()
                os.fsync(self._fh.fileno())
            except BaseException:
                self._fh.close()
                self._fh = old_fh
                os.unlink(tmp_path)
                # the aborted new-file nodes are cached under the current
                # generation: drop them and move to a fresh namespace, or
                # the next get() would read another key's value at a
                # colliding offset
                self._cache.clear()
                self._gen += 1
                self._recover()
                raise
            os.replace(tmp_path, self.path)
            # retire, don't close: a scan started before this compact
            # still preads from the old handle.  Bounded: only the most
            # recent retiree is kept (a scan spanning TWO compactions is
            # pathological); close() drops the rest.
            self._retired.append(old_fh)
            while len(self._retired) > 2:
                self._retired.pop(0).close()

    def _bulk_load(self, items) -> tuple[int, int]:
        """Build a tight tree bottom-up from sorted items."""
        live = sum(len(k) + len(v) for k, v in items)
        level = []
        for i in range(0, len(items), FANOUT):
            chunk = items[i : i + FANOUT]
            level.append((chunk[0][0], self._write_leaf_locked(chunk)))
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), FANOUT):
                chunk = level[i : i + FANOUT]
                keys = [k for k, _ in chunk[1:]]
                children = [off for _, off in chunk]
                nxt.append((chunk[0][0], self._write_branch_locked(keys, children)))
            level = nxt
        return level[0][1], live

    def count(self) -> int:
        with self._io_lock:
            return self._count

    def flush(self) -> None:
        with self._io_lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        with self._io_lock:
            self._fh.flush()
            self._fh.close()
            for fh in self._retired:
                fh.close()
            self._retired.clear()
