"""Chunk read path: resolve an entry's chunk list to visible intervals and
stream bytes from volume servers (reference filer/reader_at.go +
filer/stream.go), with gap zero-fill for sparse files.

``stream_entry`` is the hot path: an ordered iterator of byte pieces with
a bounded prefetch window — up to ``PREFETCH_WINDOW`` chunk views are
fetched ahead on a shared thread pool while earlier pieces are being
consumed, so a multi-chunk GET pipelines chunk fan-out against the
response write and never holds more than the window in memory.
``read_entry`` materializes the same stream for callers that need bytes.
All chunk HTTP rides the shared keep-alive pool (util/http_pool) instead
of a TCP connect/close per chunk.

The port's copy of seaweedfs_tpu/filer/reader.py, with the gateway
hot-chunk cache (``fetch_chunk_cached``, ``stream_entry(chunk_cache=)``).
Each chunk GET runs in a ``get_chunk`` client span whose traceparent the
volume server's ``read`` span joins; ``trace_ctx`` carries the caller's
context across the prefetch pool.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filechunks import read_chunk_views, total_size, visible_intervals
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.util.http_pool import PoolExhausted, shared_pool
from seaweedfs_tpu_torch.wdclient import MasterClient

from seaweedfs_tpu_torch.util import wlog

# chunk views fetched ahead of the consumer per streaming read: the
# memory high-water of one GET is window × chunk size, not object size
PREFETCH_WINDOW = 4
_ZERO_BLOCK = 1 << 20  # sparse holes yield bounded zero pieces

_prefetch_lock = threading.Lock()
_prefetch_pool: ThreadPoolExecutor | None = None


def _prefetcher() -> ThreadPoolExecutor:
    """Shared chunk-prefetch executor (lazy; sized for several concurrent
    streaming GETs — submissions beyond it queue, they don't fail)."""
    global _prefetch_pool
    with _prefetch_lock:
        if _prefetch_pool is None:
            _prefetch_pool = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="chunk-prefetch"
            )
        return _prefetch_pool


class ReplicaStatusError(IOError):
    """A replica answered with a non-2xx status (the peer is alive).

    ``definitive`` marks answers about the *fid itself* that no sibling
    or re-lookup can change (deleted needle, denied).  A 404 whose body
    is the volume server's "volume not found" is NOT definitive: the
    peer is alive but no longer hosts the volume — a textbook stale
    cached location, exactly what failover + re-lookup exist for."""

    def __init__(self, message: str, status: int, definitive: bool):
        super().__init__(message)
        self.status = status
        self.definitive = definitive


# statuses that are the authoritative answer for the fid itself — asking
# another replica (or re-looking-up) cannot change them
_DEFINITIVE_STATUSES = frozenset({400, 401, 403, 404, 410})
_VOLUME_GONE_BODY = b"volume not found"  # volume_server.py's volume-level 404
# an alive peer pointing elsewhere (it no longer hosts the volume):
# same stale-location semantics as the volume-level 404
_REDIRECT_STATUSES = frozenset({301, 302, 307, 308})


def _fetch_chunk_from(url: str, fid: str, offset: int, size: int, trace_ctx=None) -> bytes:
    """GET one chunk (whole or range) from one replica holder over the
    shared keep-alive pool."""
    # client span + traceparent: the hop the volume server joins when the
    # calling request is traced.  ``trace_ctx`` carries the caller's
    # context across the prefetch pool (thread-locals do not follow pool
    # workers).
    with trace.span("get_chunk", service="filer_client", parent=trace_ctx,
                    attrs={"fid": fid, "url": url}):
        headers = trace.inject_headers({})
        if size >= 0:
            headers["Range"] = f"bytes={offset}-{offset + size - 1}"
        status, body = shared_pool().request(url, "GET", f"/{fid}", headers=headers)
        if status not in (200, 206):
            definitive = status in _DEFINITIVE_STATUSES and not (
                status == 404 and body.strip() == _VOLUME_GONE_BODY
            )
            raise ReplicaStatusError(
                f"read {fid} from {url}: HTTP {status}", status, definitive
            )
    if status == 200 and size >= 0:
        body = body[offset : offset + size]  # server ignored Range
    return body


def fetch_chunk(master: MasterClient, fid: str, offset: int = 0, size: int = -1,
                trace_ctx=None) -> bytes:
    """GET one chunk, failing over across replica holders.

    Only connection-class failures mark a replica dead (forgotten from
    the wdclient cache); an HTTP error response is an *answer* from a
    live peer — definitive ones (404 deleted, 401/403 denied) propagate
    immediately, transient ones (5xx, 429) try the sibling replicas but
    keep the cache intact.  When every cached location fails at the
    connection level, the entry is invalidated and looked up fresh once
    (the master may know replicas the stale cache doesn't)."""
    import http.client

    vid = int(fid.split(",")[0])
    last_err: Exception | None = None
    for round_no in range(2):
        try:
            urls = master.lookup_urls(fid)
        except KeyError:
            if last_err is not None:
                raise IOError(f"read {fid}: all replicas failed") from last_err
            raise
        saw_connection_failure = False
        for url in urls:
            try:
                return _fetch_chunk_from(url, fid, offset, size, trace_ctx)
            except ReplicaStatusError as e:
                if e.definitive:
                    raise  # the answer, not a dead replica
                last_err = e
                if e.status == 404 or e.status in _REDIRECT_STATUSES:
                    # alive peer without the volume (volume-level 404 or
                    # a redirect to the real holder): the cached location
                    # is stale — forget it and allow the re-lookup round
                    saw_connection_failure = True
                    master.forget_location(vid, url)
                if wlog.V(1):
                    wlog.info("read %s from %s: %s, trying siblings", fid, url, e)
            except PoolExhausted as e:
                # OUR pool is saturated toward this host — the replica was
                # never contacted, so it isn't dead: keep the location
                # cache intact (a forget/invalidate here would purge
                # caches and hammer the master exactly at peak load) and
                # try a sibling, whose pool slots are independent
                last_err = e
                if wlog.V(1):
                    wlog.info("read %s from %s: %s, trying siblings", fid, url, e)
            except (OSError, http.client.HTTPException) as e:
                last_err = e
                saw_connection_failure = True
                master.forget_location(vid, url)
                if wlog.V(1):
                    wlog.info("read %s from %s failed, failing over: %s", fid, url, e)
        if round_no == 0 and saw_connection_failure:
            master.invalidate(vid)  # stale cache: re-lookup before giving up
        else:
            break
    assert last_err is not None
    raise last_err


def fetch_chunk_cached(
    cache, master: MasterClient, fid: str, offset: int, size: int, trace_ctx=None,
) -> bytes:
    """:func:`fetch_chunk` through the gateway hot-chunk cache
    (util/chunk_cache): a hit never touches the volume server, a
    cacheable miss fills single-flight, and anything the cache rejects
    (oversized, whole-chunk ``size < 0`` reads) rides the plain fetch.
    ``cache`` may be None: the zero-cost passthrough."""
    if cache is None or size < 0 or not cache.cacheable(size):
        return fetch_chunk(master, fid, offset, size, trace_ctx)
    hit = cache.lookup(fid, offset, offset + size - 1)
    if hit is not None:
        try:
            return hit.bytes_view()
        finally:
            hit.close()

    def loader() -> bytes:
        from seaweedfs_tpu_torch.stats import plane

        # the upstream fetch exists to populate the cache: bill it to
        # the cache_fill plane so warm-up traffic is distinguishable
        # from plain serve reads in weedtpu_plane_bytes_total
        with plane.tagged(plane.CACHE_FILL):
            return fetch_chunk(master, fid, offset, size, trace_ctx)

    return cache.fill(fid, offset, offset + size - 1, loader)


def delete_chunk(master: MasterClient, fid: str) -> None:
    url = master.lookup_file_id(fid)
    auth = master.sign_write(fid)
    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    status, _body = shared_pool().request(url, "DELETE", f"/{fid}", headers=headers)
    if status >= 300 and status != 404:
        # surface the failure (callers best-effort this per chunk);
        # a silent 401/5xx would leak the needle bytes forever
        raise IOError(f"delete {fid} at {url}: HTTP {status}")


def delete_entry_chunks(master: MasterClient, entry: Entry) -> None:
    """Best-effort reclamation of an entry's chunk data, expanding any
    manifest chunks so the manifest blobs are reclaimed too (shared by
    the in-process Filer and the RemoteFiler gateway seam)."""
    if master is None or not entry.chunks:
        return
    from seaweedfs_tpu_torch.filer import manifest

    chunks = entry.chunks
    if manifest.has_chunk_manifest(chunks):
        try:
            data, manifests = manifest.resolve_chunk_manifest(
                lambda fid: fetch_chunk(master, fid), chunks
            )
            chunks = data + manifests
        except Exception as e:  # noqa: BLE001 — unreadable manifest: best effort
            wlog.warning("delete: manifest for %s unreadable, deleting listed chunks only: %s", entry.full_path, e)
    for chunk in chunks:
        try:
            delete_chunk(master, chunk.fid)
        except Exception as e:  # noqa: BLE001 — orphan chunks get vacuumed
            if wlog.V(1):
                wlog.info("delete: chunk %s not deleted (vacuum will): %s", chunk.fid, e)


def resolve_chunks(master: MasterClient, entry: Entry, chunk_cache=None):
    """Expand any manifest chunks in the entry's list (no-op otherwise).

    With a ``chunk_cache``, the manifest lineage is recorded
    (``link_fids``): delete/overwrite events carry only the top-level
    chunk fids, so the cache must know which data-chunk ranges a retired
    manifest fid expands to, or they would sit unreclaimed until
    organic eviction."""
    from seaweedfs_tpu_torch.filer import manifest

    if not manifest.has_chunk_manifest(entry.chunks):
        return entry.chunks
    data, manifests = manifest.resolve_chunk_manifest(
        lambda fid: fetch_chunk(master, fid), entry.chunks
    )
    if chunk_cache is not None:
        data_fids = [c.fid for c in data]
        for m in manifests:
            chunk_cache.link_fids(m.fid, data_fids)
    return data


def _zero_fill(n: int) -> Iterator[bytes]:
    while n > 0:
        piece = min(n, _ZERO_BLOCK)
        yield bytes(piece)
        n -= piece


def stream_entry(
    master: MasterClient,
    entry: Entry,
    offset: int = 0,
    size: int = -1,
    *,
    window: int = PREFETCH_WINDOW,
    chunk_cache=None,
) -> Iterator[bytes]:
    """Yield [offset, offset+size) of a file entry as an ordered series
    of byte pieces.

    Up to ``window`` chunk views are in flight at once (submitted to the
    shared prefetch pool before the consumer needs them), so the chunk
    fan-out of view N+1..N+window overlaps writing view N to the client.
    Gaps between visible intervals (sparse files) yield zero blocks;
    Range reads, overlapping chunk versions and manifest chunks resolve
    through the same interval fold as the materializing reader.  With a
    ``chunk_cache`` (util/chunk_cache) every view consults the gateway
    hot-chunk tier before touching a volume server."""
    if entry.content:
        data = entry.content
        piece = data[offset:] if size < 0 else data[offset : offset + size]
        if piece:
            yield bytes(piece)
        return
    chunks = resolve_chunks(master, entry, chunk_cache)
    file_size = total_size(chunks)
    if size < 0:
        size = max(0, file_size - offset)
    size = min(size, max(0, file_size - offset))
    if size <= 0:
        return
    views = read_chunk_views(visible_intervals(chunks), offset, size)
    end = offset + size
    if len(views) == 1:
        # single-view read (1MB objects on the S3 hot path): fetch on
        # the calling thread — the prefetch pool has nothing to overlap
        v = views[0]
        data = fetch_chunk_cached(
            chunk_cache, master, v.fid, v.offset_in_chunk, v.size
        )
        if len(data) < v.size:
            data = data + bytes(v.size - len(data))
        if v.logical_offset > offset:
            yield from _zero_fill(v.logical_offset - offset)
        yield data[: v.size]
        if v.logical_offset + v.size < end:
            yield from _zero_fill(end - (v.logical_offset + v.size))
        return
    trace_ctx = trace.current()
    window = max(1, window)
    pool = _prefetcher()
    pending: deque = deque()  # (view, Future) in logical order
    idx = 0
    pos = offset
    try:
        while pending or idx < len(views):
            while idx < len(views) and len(pending) < window:
                v = views[idx]
                idx += 1
                pending.append(
                    (v, pool.submit(fetch_chunk_cached, chunk_cache, master, v.fid,
                                    v.offset_in_chunk, v.size, trace_ctx))
                )
            v, fut = pending.popleft()
            data = fut.result()
            if len(data) < v.size:
                # a short replica answer must not shift every later view:
                # pad to the view size (the old materializer's zero-backed
                # buffer had the same semantics)
                data = data + bytes(v.size - len(data))
            if v.logical_offset > pos:
                yield from _zero_fill(v.logical_offset - pos)
            yield data[: v.size]
            pos = v.logical_offset + v.size
        if pos < end:
            yield from _zero_fill(end - pos)
    finally:
        # consumer went away mid-stream (client disconnect): drop the
        # not-yet-started prefetches instead of fetching dead bytes
        for _v, fut in pending:
            fut.cancel()


def read_entry(
    master: MasterClient, entry: Entry, offset: int = 0, size: int = -1
) -> bytes:
    """Materialize [offset, offset+size) of a file entry (the streaming
    reader, joined — callers that can consume pieces should prefer
    :func:`stream_entry`)."""
    return b"".join(stream_entry(master, entry, offset, size))
