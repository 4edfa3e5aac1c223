"""Volume storage backends: where a .dat's bytes physically live.

The port's copy of seaweedfs_tpu/storage/backend.py (reference
weed/storage/backend/backend.go, disk_file.go, memory_map/,
s3_backend/): the volume layer reads and appends through
``BackendStorageFile``, and every byte of a local file is billed to the
calling plane (stats/plane).  ``open_backend`` makes the plain local file
(``disk``), the mmap-read local file (``mmap``) and the RAM-only file
(``memory``).  A sealed volume whose .dat moved to an object store reads
through ``TieredFile`` over an ``ObjectStoreClient``; the client shipped is
``LocalObjectStoreClient``, a directory (as in the JAX package, which has
no S3 client either).  ``DiskFile`` and ``MmapDiskFile`` consult the
``disk:`` fault injector (util/faults.py) on every call, as the JAX
DiskFile does: ``torn`` writes a strict prefix and fails, ``short`` caps
the first pwrite (the loop finishes the record), ``bitflip`` flips one
seeded bit of a read, ``eio``/``enospc`` raise; the volume layer's
crash recovery (storage/volume.py) repairs what a torn append leaves.
"""

from __future__ import annotations

import errno
import mmap
import os
import shutil
import threading
import time
from abc import ABC, abstractmethod

from seaweedfs_tpu_torch.stats import plane
from seaweedfs_tpu_torch.util import faults


class BackendStorageFile(ABC):
    name = "abstract"

    @abstractmethod
    def read_at(self, offset: int, length: int) -> bytes: ...

    @abstractmethod
    def append(self, data: bytes) -> int:
        """Write at EOF; returns the offset the data landed at."""

    @abstractmethod
    def write_at(self, offset: int, data: bytes) -> None: ...

    @abstractmethod
    def size(self) -> int: ...

    def truncate(self, size: int) -> None:
        """Drop bytes past ``size`` (torn-tail recovery on volume open)."""
        raise IOError(f"backend {self.name} does not support truncate")

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        """Push written bytes to stable storage (os.fsync where there is
        a real file); flush() only reaches the OS page cache."""

    def close(self) -> None:
        pass


def _raise_injected(rule, path: str, op: str) -> None:
    if rule.kind == "eio":
        raise OSError(errno.EIO, f"injected eio ({op} {path})")
    if rule.kind == "enospc":
        raise OSError(errno.ENOSPC, f"injected enospc ({op} {path})")


class DiskFile(BackendStorageFile):
    """Plain local file (reference backend/disk_file.go).  Holds an
    advisory exclusive flock for the life of the handle so two processes
    can never mutate the same .dat concurrently.

    All I/O is unbuffered pread/pwrite: an append that returned has
    reached the OS page cache in full, and the pwrite loop survives short
    writes; torn tails come only from real crashes or the ``disk:`` fault
    injector emulating them."""

    name = "disk"

    def __init__(self, path: str, create: bool = True):
        self.path = path
        exists = os.path.exists(path)
        if not exists and not create:
            raise FileNotFoundError(path)
        self._f = open(path, "r+b" if exists else "w+b")
        try:
            import fcntl

            fcntl.flock(self._f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:
            pass  # non-POSIX: no advisory locking
        except OSError:
            self._f.close()
            raise IOError(f"{path} is locked by another process (live volume server?)") from None
        self._io_lock = threading.Lock()

    def _post_read(self, data: bytes) -> bytes:
        rule = faults.disk_fault("read_at", self.path)
        if rule is None or not data:
            return data
        if rule.kind == "bitflip":
            at = faults.disk_randint(0, len(data) * 8 - 1)
            flipped = bytearray(data)
            flipped[at // 8] ^= 1 << (at % 8)
            return bytes(flipped)
        _raise_injected(rule, self.path, "read_at")
        return data

    def read_at(self, offset: int, length: int) -> bytes:
        t0 = time.perf_counter()
        data = os.pread(self._f.fileno(), length, offset)
        plane.account(len(data), "read", time.perf_counter() - t0)
        return self._post_read(data)

    def _pwrite_all(self, offset: int, data, first_cap: int | None = None) -> None:
        """Write every byte, surviving short pwrites (a real possibility on
        quota or RLIMIT_FSIZE boundaries, and the ``disk:*:short`` fault)."""
        fd = self._f.fileno()
        view = memoryview(data)
        pos = 0
        while pos < len(view):
            chunk = view[pos:pos + first_cap] if first_cap else view[pos:]
            first_cap = None
            n = os.pwrite(fd, chunk, offset + pos)
            if n <= 0:
                raise OSError(errno.EIO, f"pwrite returned {n} on {self.path}")
            pos += n

    def _write_fault(self, op: str, data) -> int | None:
        """Pre-write injection: raises for eio/enospc, returns a negative
        prefix length for torn (the caller writes it, then fails) and a
        first-syscall byte cap for short."""
        rule = faults.disk_fault(op, self.path)
        if rule is None:
            return None
        _raise_injected(rule, self.path, op)
        if rule.kind == "short" and len(data) > 1:
            return faults.disk_randint(1, max(1, len(data) // 2))
        if rule.kind == "torn" and len(data) > 1:
            return -faults.disk_randint(1, len(data) - 1)
        return None

    def _write_locked(self, op: str, offset: int, data, cap: int | None) -> None:
        t0 = time.perf_counter()
        if cap is not None and cap < 0:
            # torn write: a strict prefix lands, then the "crash"
            self._pwrite_all(offset, memoryview(data)[:-cap])
            raise OSError(errno.EIO, f"injected torn {op} ({-cap}/{len(data)} bytes) "
                                     f"to {self.path}")
        self._pwrite_all(offset, data, first_cap=cap)
        plane.account(len(data), "write", time.perf_counter() - t0)

    def append(self, data: bytes) -> int:
        cap = self._write_fault("append", data)
        with self._io_lock:
            offset = os.fstat(self._f.fileno()).st_size
            self._write_locked("append", offset, data, cap)
            return offset

    def write_at(self, offset: int, data: bytes) -> None:
        cap = self._write_fault("write_at", data)
        with self._io_lock:
            self._write_locked("write", offset, data, cap)

    def truncate(self, size: int) -> None:
        with self._io_lock:
            os.ftruncate(self._f.fileno(), size)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        rule = faults.disk_fault("sync", self.path)
        if rule is not None:
            _raise_injected(rule, self.path, "sync")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        # durable close: a cleanly-closed volume needs no torn-tail
        # recovery even across power loss
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass  # read-only mounts: close must still close
        self._f.close()


class MmapDiskFile(DiskFile):
    """Disk file with mmap-backed reads (reference memory_map/): repeated
    hot reads skip the pread syscall; the map follows the file's growth.

    Invariant: the map is read-only (ACCESS_READ) and serves only
    ``read_at``; every mutation (append, write_at, truncate) goes through
    the inherited pwrite path on the fd, so the map can never tear a
    record or write around the fsync policy: it is a page-cache window
    that follows the file."""

    name = "mmap"

    def __init__(self, path: str, create: bool = True):
        super().__init__(path, create)
        # (map or None, mapped size), swapped as one reference so a
        # lock-free reader never pairs one map with another's size
        self._view: tuple[mmap.mmap | None, int] = (None, 0)
        self._remap()

    def _remap(self) -> None:
        # the superseded map is never closed: a lock-free reader may hold
        # a reference taken before the swap; refcounting reclaims it once
        # the last reader drops it
        size = self.size()
        mm = mmap.mmap(self._f.fileno(), size, access=mmap.ACCESS_READ) if size > 0 else None
        self._view = (mm, size)

    def read_at(self, offset: int, length: int) -> bytes:
        if offset + length > self._view[1]:
            with self._io_lock:
                if offset + length > self._view[1]:
                    self._remap()
        mm, mm_size = self._view
        if mm is None or offset + length > mm_size:
            return super().read_at(offset, length)  # racing growth: pread
        data = mm[offset : offset + length]
        plane.account(len(data), "read")
        return self._post_read(data)

    def truncate(self, size: int) -> None:
        with self._io_lock:
            # drop the map first: a shrunk file under a live map would
            # SIGBUS any reader touching the now-unbacked tail pages
            self._view = (None, 0)
            os.ftruncate(self._f.fileno(), size)
            self._remap()

    def close(self) -> None:
        mm, _ = self._view
        self._view = (None, 0)
        if mm is not None:
            mm.close()
        super().close()


class MemoryFile(BackendStorageFile):
    """RAM-only backing: ephemeral scratch volumes and tests.  The path and
    create arguments only fit the open_backend factory's shape; nothing
    persists (sync() is a no-op by construction)."""

    name = "memory"

    def __init__(self, path: str = "", create: bool = True):
        self._buf = bytearray()
        self._lock = threading.Lock()

    def read_at(self, offset: int, length: int) -> bytes:
        with self._lock:
            return bytes(self._buf[offset : offset + length])

    def append(self, data: bytes) -> int:
        with self._lock:
            offset = len(self._buf)
            self._buf += data
            return offset

    def write_at(self, offset: int, data: bytes) -> None:
        with self._lock:
            end = offset + len(data)
            if end > len(self._buf):
                self._buf += b"\x00" * (end - len(self._buf))
            self._buf[offset:end] = data

    def truncate(self, size: int) -> None:
        with self._lock:
            del self._buf[size:]

    def size(self) -> int:
        with self._lock:
            return len(self._buf)


class ObjectStoreClient(ABC):
    """What a remote tier must provide (the S3-client shape the
    reference's s3_backend wraps)."""

    name = "abstract"

    @abstractmethod
    def put(self, key: str, local_path: str) -> None: ...

    @abstractmethod
    def read_range(self, key: str, offset: int, length: int) -> bytes: ...

    @abstractmethod
    def object_size(self, key: str) -> int: ...

    @abstractmethod
    def get(self, key: str, local_path: str) -> None: ...

    @abstractmethod
    def delete(self, key: str) -> None: ...


class LocalObjectStoreClient(ObjectStoreClient):
    """Directory-backed object store, the in-tree tier target: object
    ``a/b/c`` is the file ``root/a_b_c``, as in the JAX package, so each
    package reads the other's uploads."""

    name = "local"

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_"))

    def put(self, key: str, local_path: str) -> None:
        tmp = self._path(key) + ".part"
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, self._path(key))

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def object_size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def get(self, key: str, local_path: str) -> None:
        tmp = local_path + ".part"
        shutil.copyfile(self._path(key), tmp)
        os.replace(tmp, local_path)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class TieredFile(BackendStorageFile):
    """Read-only view of a .dat living in an object store (reference
    s3_backend.S3BackendStorageFile): sealed volumes only.  Appends are
    refused; reads are ranged GETs of 1 MiB blocks behind a 32-block
    (32 MiB) cache that evicts the oldest block first."""

    name = "remote"

    _BLOCK = 1024 * 1024
    _CACHE_BLOCKS = 32

    def __init__(self, client: ObjectStoreClient, key: str, size: int | None = None):
        self.client = client
        self.key = key
        self._size = size if size is not None else client.object_size(key)
        self._cache: dict[int, bytes] = {}
        self._cache_order: list[int] = []
        self._lock = threading.Lock()

    def _block(self, idx: int) -> bytes:
        with self._lock:
            if idx in self._cache:
                return self._cache[idx]
        data = self.client.read_range(self.key, idx * self._BLOCK, self._BLOCK)
        with self._lock:
            if idx not in self._cache:
                self._cache[idx] = data
                self._cache_order.append(idx)
                if len(self._cache_order) > self._CACHE_BLOCKS:
                    self._cache.pop(self._cache_order.pop(0), None)
        return data

    def read_at(self, offset: int, length: int) -> bytes:
        out = bytearray()
        while length > 0 and offset < self._size:
            idx, within = divmod(offset, self._BLOCK)
            piece = self._block(idx)[within : within + length]
            if not piece:
                break
            out += piece
            offset += len(piece)
            length -= len(piece)
        return bytes(out)

    def append(self, data: bytes) -> int:
        raise IOError(f"tiered volume {self.key} is sealed (read-only)")

    def write_at(self, offset: int, data: bytes) -> None:
        raise IOError(f"tiered volume {self.key} is sealed (read-only)")

    def size(self) -> int:
        return self._size


_BACKENDS = {"disk": DiskFile, "mmap": MmapDiskFile, "memory": MemoryFile}


def open_backend(kind: str, path: str, create: bool = True) -> BackendStorageFile:
    try:
        return _BACKENDS[kind](path, create)
    except KeyError:
        raise ValueError(f"unknown volume backend {kind!r}") from None
