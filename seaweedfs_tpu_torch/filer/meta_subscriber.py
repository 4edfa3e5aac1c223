"""Cross-process entry-cache invalidation plane.

A gateway over a shared filer cannot see mutations performed by OTHER
processes (another gateway, a shell command, the filer's own HTTP API)
through its in-process ``listeners``.  This module subscribes to the
filer's **metadata event log** (the ``SubscribeMetadata`` stream) and
drops the affected paths from the entry cache as events arrive.
Coherence is bounded by stream latency for any mutator, with the cache
TTL as the backstop:

- a lost/broken stream degrades to the TTL bound (the subscriber also
  signals ``on_gap`` so the cache can drop everything it holds — a
  reconnect re-reads from the last seen ts, but a filer restart may
  have truncated the log);
- subscription is per filer address, each a cheap polling stream with
  short deadlines (a DEADLINE_EXCEEDED ending a quiet poll is normal,
  not a failure).

Events are counted in ``weedtpu_filer_meta_sub_total{event=...}``.

The stream also feeds the hot-chunk cache tier (util/chunk_cache):
chunk fids an event *retires* (delete / overwrite — :func:`event_fids`)
ride the same ``on_paths`` callback as ``fid:``-prefixed lines
(``FID_PREFIX``), so one seam keeps both the entry cache and the chunk
cache current.  For the chunk tier this is pure reclamation: fids are
immutable, so a cached body can never be *wrong*, only retired.

The port's copy of seaweedfs_tpu/filer/meta_subscriber.py, over the port's
``rpc.filer_stub``.
"""

from __future__ import annotations

import threading
import time

import grpc

from seaweedfs_tpu_torch import rpc
# the line prefix that marks a retired chunk fid among invalidated paths:
# one definition, the worker-group bus's wire convention (re-exported)
from seaweedfs_tpu_torch.filer.inval_bus import FID_PREFIX
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.util import wlog


def event_fids(old_entry, new_entry) -> list[str]:
    """Chunk fids one metadata event *retires* — the old entry's chunks
    minus any the new entry still references.  Fids are immutable, so
    the hot-chunk cache (util/chunk_cache) only ever needs to hear about
    retirement: a delete or overwrite frees those ranges for reclaim
    (correctness never depended on them — a live fid's bytes can't
    change).  Works on both pb entries (this stream) and the in-process
    dataclass entries (``Filer.listeners`` events): both spell ``.fid``."""
    if old_entry is None:
        return []
    keep = set()
    if new_entry is not None:
        for c in getattr(new_entry, "chunks", ()) or ():
            keep.add(c.fid)
    out = []
    for c in getattr(old_entry, "chunks", ()) or ():
        if c.fid and c.fid not in keep:
            out.append(c.fid)
    return out


def event_paths(directory: str, old_entry, new_entry, new_parent_path: str) -> list[str]:
    """The cache keys one metadata event invalidates — the same set the
    in-process EntryCache listener drops (old path, new path, and the
    rename-destination composition)."""
    paths = []
    for e in (old_entry, new_entry):
        if e is not None and getattr(e, "name", ""):
            base = getattr(e, "full_path", "") or (
                directory.rstrip("/") + "/" + e.name
            )
            paths.append(base)
    if new_parent_path and new_entry is not None and new_entry.name:
        paths.append(new_parent_path.rstrip("/") + "/" + new_entry.name)
    return paths


class MetaSubscriber:
    """Tail each filer's metadata log; call ``on_paths(list[str])`` per
    event and ``on_gap()`` when events may have been missed."""

    def __init__(
        self,
        addresses: list[str],
        on_paths,
        *,
        prefix: str = "",
        on_gap=None,
        poll_timeout: float = 2.0,
        client_name: str = "gateway-inval",
    ):
        self.addresses = list(addresses)
        self.on_paths = on_paths
        self.on_gap = on_gap
        self.prefix = prefix
        self.poll_timeout = poll_timeout
        self.client_name = client_name
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.events = 0  # totals across shards (stats() snapshot)
        self.reconnects = 0
        self.gaps = 0

    def start(self) -> None:
        for addr in self.addresses:
            t = threading.Thread(
                target=self._tail, args=(addr,), daemon=True,
                name=f"meta-sub:{addr}",
            )
            t.start()
            self._threads.append(t)

    # events carry the FILER host's wall clock while the start point is
    # OURS: a gateway clock ahead of a shard's would silently filter
    # that shard's events for the skew duration (no stream error, so no
    # gap signal).  Start this far in the (filer's) past instead — the
    # replayed window costs only cheap cache invalidations, and residual
    # skew beyond it is absorbed by the entry-cache TTL backstop.
    SKEW_ALLOWANCE_S = 60.0

    def _tail(self, addr: str) -> None:
        from seaweedfs_tpu_torch import stats

        # meta-log event ts_ns are wall-clock: this is the stream's start
        # point, not a duration
        since = time.time_ns() - int(self.SKEW_ALLOWANCE_S * 1e9)
        healthy = True
        while not self._stop.is_set():
            try:
                stream = rpc.filer_stub(addr).SubscribeMetadata(
                    f_pb.SubscribeMetadataRequest(
                        client_name=self.client_name,
                        path_prefix=self.prefix,
                        since_ts_ns=since,
                    ),
                    timeout=self.poll_timeout,
                )
                for ev in stream:
                    since = max(since, ev.ts_ns)
                    healthy = True
                    old = ev.old_entry if ev.HasField("old_entry") else None
                    new = ev.new_entry if ev.HasField("new_entry") else None
                    paths = event_paths(
                        ev.directory, old, new, ev.new_parent_path,
                    )
                    # retired chunk fids ride the same callback as
                    # prefixed lines so one seam invalidates both tiers
                    paths += [
                        FID_PREFIX + fid for fid in event_fids(old, new)
                    ]
                    if paths:
                        self.events += 1
                        stats.META_SUB.inc(event="event")
                        try:
                            self.on_paths(paths)
                        except Exception as e:  # noqa: BLE001 — invalidation is advisory; TTL still bounds
                            wlog.warning("meta_sub: handler failed: %s", e)
                    if self._stop.is_set():
                        return
            except grpc.RpcError as e:
                code = getattr(e, "code", lambda: None)()
                if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                    # quiet poll window ended — the normal idle cadence,
                    # NOT a coherence gap (since_ts_ns resumes exactly)
                    continue
                # transport failure: events may be flowing while we are
                # blind — tell the cache once per outage, then back off
                if healthy:
                    healthy = False
                    self.gaps += 1
                    stats.META_SUB.inc(event="gap")
                    if self.on_gap is not None:
                        try:
                            self.on_gap()
                        except Exception as ge:  # noqa: BLE001 — advisory
                            wlog.warning("meta_sub: on_gap failed: %s", ge)
                self.reconnects += 1
                stats.META_SUB.inc(event="reconnect")
                self._stop.wait(0.2)
        # loop exit: stop() requested

    def stats(self) -> dict:
        return {
            "shards": len(self.addresses),
            "events": self.events,
            "reconnects": self.reconnects,
            "gaps": self.gaps,
        }

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=self.poll_timeout + 1.0)
