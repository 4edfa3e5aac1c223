"""Volume storage backends: where a .dat's bytes physically live.

The port's copy of the disk half of seaweedfs_tpu/storage/backend.py
(reference weed/storage/backend/backend.go, disk_file.go): the volume
layer reads and appends through ``BackendStorageFile``, and every byte is
billed to the calling plane (stats/plane).  Only the plain local file
(``DiskFile``, ``open_backend("disk")``) is ported; the mmap, memory and
tiered (object-store) files and the ``disk:`` fault injector are not.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from abc import ABC, abstractmethod

from seaweedfs_tpu_torch.stats import plane


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


class DiskFile(BackendStorageFile):
    """Plain local file (reference backend/disk_file.go).  Holds an
    advisory exclusive flock for the life of the handle so two processes
    can never mutate the same .dat concurrently.

    All I/O is unbuffered pread/pwrite: an append that returned has
    reached the OS page cache in full, and the pwrite loop survives short
    writes."""

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

    def read_at(self, offset: int, length: int) -> bytes:
        t0 = time.perf_counter()
        data = os.pread(self._f.fileno(), length, offset)
        plane.account(len(data), "read", time.perf_counter() - t0)
        return data

    def _pwrite_all(self, offset: int, data) -> None:
        """Write every byte, surviving short pwrites."""
        fd = self._f.fileno()
        view = memoryview(data)
        pos = 0
        while pos < len(view):
            n = os.pwrite(fd, view[pos:], offset + pos)
            if n <= 0:
                raise OSError(errno.EIO, f"pwrite returned {n} on {self.path}")
            pos += n

    def append(self, data: bytes) -> int:
        with self._io_lock:
            t0 = time.perf_counter()
            offset = os.fstat(self._f.fileno()).st_size
            self._pwrite_all(offset, data)
            plane.account(len(data), "write", time.perf_counter() - t0)
            return offset

    def write_at(self, offset: int, data: bytes) -> None:
        with self._io_lock:
            t0 = time.perf_counter()
            self._pwrite_all(offset, data)
            plane.account(len(data), "write", time.perf_counter() - t0)

    def truncate(self, size: int) -> None:
        with self._io_lock:
            os.ftruncate(self._f.fileno(), size)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
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


_BACKENDS = {"disk": DiskFile}


def open_backend(kind: str, path: str, create: bool = True) -> BackendStorageFile:
    try:
        return _BACKENDS[kind](path, create)
    except KeyError:
        raise ValueError(f"unknown volume backend {kind!r}") from None
