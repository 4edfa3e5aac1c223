"""Metadata cache for the mount, invalidated by the filer event stream.

Counterpart of the reference's weed/mount/meta_cache/: positive and
negative lookups cached with a TTL; a background subscriber tails
SubscribeMetadata under the mounted prefix and drops affected paths so
cross-mount changes show up without waiting out the TTL.

The port's copy of seaweedfs_tpu/mount/meta_cache.py.
"""

from __future__ import annotations

import threading
import time

import grpc

from seaweedfs_tpu_torch.filer.entry import Entry


class MetaCache:
    _MISSING = object()

    def __init__(self, client, root: str = "/", ttl: float = 5.0):
        self.client = client
        self.root = root.rstrip("/") or "/"
        self.ttl = ttl
        self._cache: dict[str, tuple[float, object]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.invalidations = 0

    # ---- lookup ----------------------------------------------------------
    def lookup(self, path: str) -> Entry | None:
        now = time.time()
        with self._lock:
            hit = self._cache.get(path)
            if hit is not None and hit[0] > now:
                val = hit[1]
                return None if val is self._MISSING else val
        entry = self.client.lookup(path)
        with self._lock:
            self._cache[path] = (
                now + self.ttl,
                entry if entry is not None else self._MISSING,
            )
        return entry

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._cache.pop(path, None)
            self._cache.pop(path.rstrip("/").rsplit("/", 1)[0] or "/", None)
        self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._cache = {}

    # ---- event-driven invalidation --------------------------------------
    def start_subscriber(self) -> None:
        self._thread = threading.Thread(target=self._tail, daemon=True)
        self._thread.start()

    def _tail(self) -> None:
        since = time.time_ns()
        while not self._stop.is_set():
            try:
                for ev in self.client.subscribe(self.root, since, timeout=2.0):
                    since = max(since, ev.ts_ns)
                    for e, d in (
                        (ev.old_entry, ev.directory),
                        (ev.new_entry, ev.new_parent_path or ev.directory),
                    ):
                        if e.name:
                            self.invalidate(d.rstrip("/") + "/" + e.name)
                    if self._stop.is_set():
                        return
            except grpc.RpcError:
                pass  # stream deadline / filer restart: reconnect
            self._stop.wait(0.05)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
