"""WeedFS: the filesystem object behind a mount.

Counterpart of the reference's weed/mount/weedfs.go (:78) and its
weedfs_file_*.go / weedfs_dir_*.go operation files: POSIX-shaped
operations over a remote filer with a write-back page cache per open
file and a subscription-invalidated metadata cache.  The kernel binding
(fuse_adapter.py) is a thin shim over this object — all semantics live
here, testable without a kernel.

The port's copy of seaweedfs_tpu/mount/weedfs.py.
"""

from __future__ import annotations

import errno
import hashlib
import threading
import time
from dataclasses import replace

from seaweedfs_tpu_torch.filer import manifest as chunk_manifest
from seaweedfs_tpu_torch.filer import reader as chunk_reader
from seaweedfs_tpu_torch.filer import upload as chunk_upload
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filechunks import total_size
from seaweedfs_tpu_torch.mount.filer_client import FilerClient, FilerError
from seaweedfs_tpu_torch.mount.meta_cache import MetaCache
from seaweedfs_tpu_torch.mount.page_writer import PageWriter


class FuseError(OSError):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(err, msg or errno.errorcode.get(err, str(err)))
        self.errno = err


class _OpenFile:
    """Shared per-path open state: every handle to one file shares the
    entry snapshot and page cache (the reference shares one file handle
    per inode) — two handles flushing must not last-writer-win each
    other's chunks away."""

    def __init__(self, entry: Entry, chunk_size: int):
        self.entry = entry
        self.pages = PageWriter(chunk_size)
        self.lock = threading.Lock()
        self.refs = 0
        self.unlinked = False  # flushes stop committing after unlink
        self.reclaim_on_release = None  # Entry whose chunks die at close


class WeedFS:
    def __init__(
        self,
        filer_grpc: str,
        master_grpc: str,
        *,
        root: str = "/",
        chunk_size: int = 4 * 1024 * 1024,
        manifest_batch: int = chunk_manifest.MANIFEST_BATCH,
        cache_ttl: float = 5.0,
        subscribe: bool = True,
    ):
        self.client = FilerClient(filer_grpc, master_grpc)
        self.root = root.rstrip("/") or "/"
        self.chunk_size = chunk_size
        self.manifest_batch = manifest_batch
        self.meta = MetaCache(self.client, self.root, ttl=cache_ttl)
        if subscribe:
            self.meta.start_subscriber()
        self._handles: dict[int, _OpenFile] = {}
        self._open_by_path: dict[str, _OpenFile] = {}
        self._next_fh = 1
        self._lock = threading.Lock()

    # ---- path helpers ----------------------------------------------------
    def _abs(self, path: str) -> str:
        path = "/" + path.strip("/")
        if self.root == "/":
            return path
        return self.root + (path if path != "/" else "")

    def _entry(self, path: str) -> Entry:
        e = self.meta.lookup(self._abs(path))
        if e is None:
            raise FuseError(errno.ENOENT, path)
        return e

    # ---- directory ops ---------------------------------------------------
    def getattr(self, path: str) -> dict:
        full = self._abs(path)
        if full == self.root:
            return {"mode": 0o755, "is_dir": True, "size": 0, "mtime": 0.0}
        e = self._entry(path)
        size = e.size
        # an open dirty handle may extend past the committed size
        with self._lock:
            for of in self._handles.values():
                if of.entry.full_path == full:
                    size = max(size, of.pages.dirty_size_ceiling())
        return {
            "mode": e.attr.mode,
            "is_dir": e.is_directory,
            "size": size,
            "mtime": e.attr.mtime,
        }

    def readdir(self, path: str) -> list[str]:
        full = self._abs(path)
        if full != self.root:
            e = self._entry(path)
            if not e.is_directory:
                raise FuseError(errno.ENOTDIR, path)
        return [e.name for e in self.client.list(full)]

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        full = self._abs(path)
        if self.meta.lookup(full) is not None:
            raise FuseError(errno.EEXIST, path)
        self.client.create(
            Entry(full, is_directory=True, attr=Attr.now(mode=mode))
        )
        self.meta.invalidate(full)

    def rmdir(self, path: str) -> None:
        e = self._entry(path)
        if not e.is_directory:
            raise FuseError(errno.ENOTDIR, path)
        if self.client.list(e.full_path, limit=2):
            raise FuseError(errno.ENOTEMPTY, path)
        self.client.delete(e.full_path)
        self.meta.invalidate(e.full_path)

    def unlink(self, path: str) -> None:
        e = self._entry(path)
        if e.is_directory:
            raise FuseError(errno.EISDIR, path)
        self.client.delete(e.full_path)
        self.meta.invalidate(e.full_path)
        with self._lock:
            of = self._open_by_path.pop(e.full_path, None)
        if of is not None:
            # open handles keep reading their snapshot, but a later
            # flush must not resurrect the deleted file
            of.unlinked = True

    def rename(self, old: str, new: str) -> None:
        self._entry(old)
        old_full, new_full = self._abs(old), self._abs(new)
        if old_full == new_full:
            return
        # rename-over: the overwritten destination's chunks must be
        # reclaimed (the filer's rename upserts metadata only)
        doomed = self.meta.lookup(new_full)
        with self._lock:
            of = self._open_by_path.get(old_full)
            # handles already open on the destination keep reading the
            # doomed snapshot (POSIX): defer its reclaim to their release
            dest_of = self._open_by_path.get(new_full)
        if of is not None:
            # serialize against an in-flight flush: re-homing of.entry
            # mid-commit would let the flush resurrect the old path and
            # then clobber the re-home
            with of.lock:
                self._rename_locked(old_full, new_full)
                of.entry = replace(of.entry, full_path=new_full)
                with self._lock:
                    if self._open_by_path.get(old_full) is of:
                        self._open_by_path.pop(old_full, None)
                    self._open_by_path[new_full] = of
        else:
            self._rename_locked(old_full, new_full)
        if doomed is not None and not doomed.is_directory and doomed.chunks:
            if dest_of is not None and dest_of is not of:
                # open readers of the overwritten file keep their data
                # until the last close; flushes must not resurrect it
                dest_of.unlinked = True
                dest_of.reclaim_on_release = doomed
            else:
                self.client.reclaim_chunks(doomed)
        self.meta.invalidate(old_full)
        self.meta.invalidate(new_full)

    def _rename_locked(self, old_full: str, new_full: str) -> None:
        try:
            # deliberate RPC under of.lock (per-open-file, not the global map
            # lock): the filer rename must commit before any concurrent flush of
            # the same file can resurrect the old path; only same-file writers wait
            # weedlint: disable=W010 — rename must commit under of.lock (see above)
            self.client.rename(old_full, new_full)
        except FilerError as e:
            raise FuseError(errno.EIO, str(e)) from e

    # ---- file ops --------------------------------------------------------
    def create(self, path: str, mode: int = 0o644) -> int:
        full = self._abs(path)
        existing = self.meta.lookup(full)
        if existing is not None and existing.is_directory:
            raise FuseError(errno.EISDIR, path)
        entry = Entry(full, attr=Attr.now(mode=mode))
        try:
            self.client.create(entry)
        except FilerError as e:
            raise FuseError(errno.EIO, str(e)) from e
        self.meta.invalidate(full)
        return self._register(entry)

    def open(self, path: str) -> int:
        e = self._entry(path)
        if e.is_directory:
            raise FuseError(errno.EISDIR, path)
        return self._register(e)

    def _register(self, entry: Entry) -> int:
        with self._lock:
            of = self._open_by_path.get(entry.full_path)
            if of is None or of.unlinked:
                of = _OpenFile(entry, self.chunk_size)
                self._open_by_path[entry.full_path] = of
            of.refs += 1
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = of
            return fh

    def _of(self, fh: int) -> _OpenFile:
        with self._lock:
            of = self._handles.get(fh)
        if of is None:
            raise FuseError(errno.EBADF, str(fh))
        return of

    def read(self, fh: int, offset: int, size: int) -> bytes:
        of = self._of(fh)
        with of.lock:
            committed = total_size(of.entry.chunks) if not of.entry.content else len(of.entry.content)
            end = max(committed, of.pages.dirty_size_ceiling())
            size = min(size, max(0, end - offset))
            if size <= 0:
                return b""
            # read_entry now rides the streaming reader: chunk fan-out
            # pipelines behind a bounded prefetch window, so a large
            # read fetches view N+1 while view N is being assembled
            base = chunk_reader.read_entry(
                self.client.master, of.entry, offset, size
            )
            if len(base) < size:  # dirty region past the committed end
                base = base + b"\x00" * (size - len(base))
            return of.pages.overlay(base, offset)

    def write(self, fh: int, offset: int, data: bytes) -> int:
        of = self._of(fh)
        with of.lock:
            of.pages.write(offset, data)
        return len(data)

    def truncate(self, path: str, length: int) -> None:
        """Only truncate-to-zero is supported (the common creat/O_TRUNC
        path); partial truncation of chunked files needs chunk surgery
        the reference also routes through a full rewrite."""
        e = self._entry(path)
        if length == 0:
            old_chunks = list(e.chunks)
            e = replace(e, chunks=[], content=b"")
            try:
                self.client.update(e)
            except FilerError as err:
                raise FuseError(errno.EIO, str(err)) from err
            if old_chunks:
                self.client.reclaim_chunks(replace(e, chunks=old_chunks))
            self.meta.invalidate(e.full_path)
            with self._lock:
                handles = [
                    of
                    for of in self._handles.values()
                    if of.entry.full_path == e.full_path
                ]
            for of in handles:
                with of.lock:
                    of.entry = e
                    # POSIX: truncate discards buffered writes too — they
                    # must not resurrect on the next flush
                    of.pages.mark_clean()
        elif length != e.size:
            raise FuseError(errno.ENOSYS, "partial truncate")

    def flush(self, fh: int) -> None:
        of = self._of(fh)
        with of.lock:
            if not of.pages.dirty or of.unlinked:
                return
            # build the committed state on a copy: a failed update must
            # leave of.entry AND the dirty pages untouched for retry
            base_chunks = list(of.entry.chunks)
            # inline content becomes a chunk FIRST so its timestamp
            # predates every dirty chunk uploaded below — otherwise the
            # old content would shadow the new writes in the
            # latest-wins interval fold
            if of.entry.content:
                content = of.entry.content
                fid = chunk_upload.save_blob(self.client.master, content)
                base_chunks = [
                    FileChunk(
                        fid=fid, offset=0, size=len(content),
                        modified_ts_ns=time.time_ns(),
                        e_tag=hashlib.md5(content).hexdigest(),
                    )
                ]
            new_chunks = of.pages.flush_to_chunks(
                lambda data: chunk_upload.save_blob(self.client.master, data)
            )
            merged = chunk_manifest.maybe_manifestize(
                lambda blob: chunk_upload.save_blob(self.client.master, blob),
                base_chunks + new_chunks,
                self.manifest_batch,
            )
            updated = replace(
                of.entry,
                chunks=merged,
                content=b"",
                attr=replace(of.entry.attr, mtime=time.time()),
            )
            try:
                self.client.update(updated)
            except FilerError as e:
                # dirty intervals survive: a retried flush re-uploads and
                # re-commits instead of silently dropping the writes
                raise FuseError(errno.EIO, str(e)) from e
            of.entry = updated
            of.pages.mark_clean()
            self.meta.invalidate(updated.full_path)

    def release(self, fh: int) -> None:
        self.flush(fh)
        reclaim = None
        with self._lock:
            of = self._handles.pop(fh, None)
            if of is not None:
                of.refs -= 1
                if of.refs <= 0:
                    if self._open_by_path.get(of.entry.full_path) is of:
                        self._open_by_path.pop(of.entry.full_path, None)
                    reclaim = of.reclaim_on_release
                    of.reclaim_on_release = None
        if reclaim is not None:
            # the file this handle kept alive past its rename-over
            self.client.reclaim_chunks(reclaim)

    def statfs(self) -> dict:
        return {"bsize": self.chunk_size, "frsize": 4096}

    def close(self) -> None:
        with self._lock:
            fhs = list(self._handles)
        for fh in fhs:
            try:
                self.release(fh)
            except FuseError:
                pass
        self.meta.stop()
