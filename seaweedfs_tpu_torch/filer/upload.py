"""Chunked upload: split a stream into chunks, assign fids, POST to volume
servers in parallel (reference filer_server_handlers_write_upload.go:56
uploadReaderToChunks + assignNewFileInfo:37).  The port's copy of
seaweedfs_tpu/filer/upload.py: ``FidPool(native_stash=True)`` parks its
reservations in the native data plane's fid stash (csrc/dp.cpp
``sw_px_stash_*``) unless ``SEAWEEDFS_TPU_NATIVE_PX=0``.  Each chunk POST runs in a ``put_chunk`` client span whose traceparent the
volume server's ``write`` span joins (stats/trace.py).

One Assign RPC covers a batch of chunks via the ``fid_N`` convention
(the master reserves ``count`` sequential keys; derivatives share the
base fid's cookie and locations, and a write token for the base covers
them — security/jwt.py), so a large object costs ~chunks/ASSIGN_BATCH
round trips to the master instead of one per chunk.  Chunk bodies ride
the shared keep-alive pool, and the in-flight window is a
BoundedSemaphore released by the worker — O(window) memory, no O(n²)
future-list rescans.
"""

from __future__ import annotations

import hashlib
import io
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from seaweedfs_tpu_torch.filer.entry import FileChunk
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.util.http_pool import shared_pool
from seaweedfs_tpu_torch.wdclient import MasterClient

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024  # filer -maxMB default
INLINE_LIMIT = 2048  # small files stay in the entry (reference saveAsChunk cutoff is similar in spirit)
ASSIGN_BATCH = 8  # fids reserved per Assign RPC (fid_N convention)


class FidPool:
    """Cross-request assign batching for gateways: one Assign RPC
    reserves ``batch`` fids (fid_N convention) served to subsequent
    uploads with the same placement parameters, so a stream of
    single-chunk object PUTs costs ~1/batch of an assign round trip
    each instead of one apiece.

    Reservations are kept in ``stripes`` independent batches and served
    round-robin: every Assign lands on one volume (the fid_N keys share
    it), so a single batch would funnel all concurrent writers through
    one volume's serialized appender — striping keeps up to ``stripes``
    volumes appending in parallel, like per-request assigns did.

    Reservations age out after ``ttl`` seconds: assign-time auth tokens
    live ~10s, and a long-idle reservation could point at a volume the
    master has since stopped writing to.  Expired or raced-away fids are
    simply unused sequence numbers — the volume never saw them.

    With ``native_stash=True`` (and the splice not disabled) the
    reservations are parked in the native plane instead (dp.cpp
    ``sw_px_stash_*``): each entry carries the fid, the full holder set
    (primary + replicas) and the assign auth, so the PUT fan-out draws a
    ready fid + replica set with one native call.  The native stash
    round-robins stripes like the Python pools (each batch lands on one
    volume; FIFO would serialize writers behind one appender)."""

    def __init__(
        self,
        master: MasterClient,
        batch: int = 8,
        ttl: float = 3.0,
        stripes: int = 8,
        native_stash: bool = False,
    ):
        self.master = master
        self.batch = batch
        self.ttl = ttl
        self.stripes = stripes
        self.native_stash = native_stash
        # (collection, replication, ttl_s, disk, growth)
        #   -> [[batch_expiry, [fid_tuple, ...]], ...] round-robin'd;
        # fid_tuple = (fid, url, auth, (replica_url, ...))
        self._pools: dict[tuple, list] = {}
        self._rr = 0
        self._stripe_seq = 0
        self._stash_keys: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def _stash_key(self, key: tuple) -> int:
        # salted with the master addresses: the native stash is
        # process-global, and two gateways against different clusters in
        # one process must never take each other's reservations
        cached = self._stash_keys.get(key)
        if cached is not None:
            return cached
        salt = (tuple(self.master.master_addresses), key)
        kh = int.from_bytes(hashlib.blake2b(repr(salt).encode(), digest_size=8).digest(),
                            "little")
        if len(self._stash_keys) < 256:  # placement tuples are few
            self._stash_keys[key] = kh
        return kh

    def _stash(self):
        """The native stash module, or None when not asked for or the
        splice is disabled."""
        if not self.native_stash:
            return None
        from seaweedfs_tpu_torch.native import dataplane

        return dataplane if dataplane.px_lib() is not None else None

    def take(
        self,
        count: int = 1,
        *,
        collection: str = "",
        replication: str = "",
        ttl_seconds: int = 0,
        disk_type: str = "",
        writable_volume_count: int = 0,
    ) -> list[tuple[str, str, str]]:
        return [
            t[:3]
            for t in self.take_located(
                count, collection=collection, replication=replication,
                ttl_seconds=ttl_seconds, disk_type=disk_type,
                writable_volume_count=writable_volume_count,
            )
        ]

    def take_located(
        self,
        count: int = 1,
        *,
        collection: str = "",
        replication: str = "",
        ttl_seconds: int = 0,
        disk_type: str = "",
        writable_volume_count: int = 0,
    ) -> list[tuple[str, str, str, tuple[str, ...]]]:
        """take() plus each fid's replica holder set (the fan-out's
        ready fid + replica set)."""
        key = (collection, replication, ttl_seconds, disk_type, writable_volume_count)
        out: list[tuple[str, str, str, tuple[str, ...]]] = []
        now = time.monotonic()
        stash = self._stash()
        stash_low = False
        if stash is not None:
            kh = self._stash_key(key)
            remaining = 0
            while len(out) < count:
                ent = stash.px_stash_take(kh)
                if ent is None:
                    break
                fid, addrs, auth, remaining = ent
                out.append((fid, addrs[0], auth, tuple(addrs[1:])))
            # the low-water signal rides the take itself (approximate
            # leftover depth): no second scan per draw
            stash_low = remaining < self.batch
            if len(out) == count and not stash_low:
                return out
        with self._lock:
            batches = [
                b for b in self._pools.get(key, []) if b[0] > now and b[1]
            ]
            self._pools[key] = batches
            while len(out) < count and batches:
                self._rr = (self._rr + 1) % len(batches)
                out.append(batches[self._rr][1].pop(0))
                if not batches[self._rr][1]:
                    batches.pop(self._rr)
            refill = len(batches) < self.stripes
        if len(out) == count and not refill and not stash_low:
            return out
        # refill outside the lock — the assign RPC must not serialize
        # every uploading thread behind one holder
        fresh = self.master.assign_batch_located(
            max(self.batch, count - len(out)), collection=collection,
            replication=replication, ttl_seconds=ttl_seconds,
            disk_type=disk_type, writable_volume_count=writable_volume_count,
        )
        while len(out) < count:
            out.append(fresh.pop(0))
        if fresh and stash is not None:
            kh = self._stash_key(key)
            with self._lock:
                self._stripe_seq += 1
                stripe = self._stripe_seq
            ttl_ms = int(self.ttl * 1000)
            # stash-full leftovers stay Python-side
            fresh = [ent for ent in fresh
                     if not stash.px_stash_push(kh, stripe, ent[0], [ent[1], *ent[3]], ent[2],
                                                ttl_ms)]
        if fresh:
            with self._lock:
                batches = self._pools.setdefault(key, [])
                if len(batches) < self.stripes * 2:  # racing refills bounded
                    batches.append([now + self.ttl, fresh])
        return out


def http_put_chunk(
    url: str,
    fid: str,
    data: bytes,
    timeout: float = 30.0,
    auth: str = "",
    content_type: str = "",
    trace_ctx=None,
) -> None:
    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    if content_type:
        # lets the volume server's compress-on-write heuristic see the
        # file's real type (chunk bodies are opaque ranges otherwise)
        headers["Content-Type"] = content_type
    # client span: ``trace_ctx`` carries the caller's context across the
    # upload thread pool (thread-locals do not follow pool workers); the
    # traceparent header hands it to the volume server
    with trace.span("put_chunk", service="filer_client", parent=trace_ctx,
                    attrs={"fid": fid, "url": url}):
        trace.inject_headers(headers)
        status, body = shared_pool().request(
            url, "POST", f"/{fid}", body=data, headers=headers, timeout=timeout
        )
        if status not in (200, 201):
            raise IOError(
                f"upload {fid} to {url}: HTTP {status} {body[:200]!r}"
            )


def save_blob(
    master: MasterClient,
    data: bytes,
    *,
    collection: str = "",
    replication: str = "",
    ttl_seconds: int = 0,
    disk_type: str = "",
    growth_count: int = 0,
) -> str:
    """Assign a fid and store one blob; returns the fid (the SaveFn shape
    manifest.maybe_manifestize needs)."""
    assign = master.assign(
        collection=collection, replication=replication,
        ttl_seconds=ttl_seconds, disk_type=disk_type,
        writable_volume_count=growth_count,
    )
    auth = master.sign_write(assign.fid) or assign.auth
    http_put_chunk(assign.location.url, assign.fid, data, auth=auth)
    return assign.fid


def upload_stream(
    master: MasterClient,
    reader: io.BufferedIOBase,
    *,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    collection: str = "",
    replication: str = "",
    ttl_seconds: int = 0,
    disk_type: str = "",
    growth_count: int = 0,
    parallelism: int = 4,
    inline_limit: int = INLINE_LIMIT,
    mime: str = "",
    assign_batch: int = ASSIGN_BATCH,
    fid_pool: FidPool | None = None,
) -> tuple[list[FileChunk], bytes, str]:
    """Returns (chunks, inline_content, md5_etag).

    Small payloads (≤ inline_limit, single read) come back as inline
    content with no chunks, the reference's small-file inlining; pass
    ``inline_limit=0`` to force chunking (multipart parts must be
    chunk-backed so completion can merge chunk lists without copying).

    ``reader`` may be any file-like yielding bytes — gateways hand the
    request socket straight in, so the object body streams through an
    O(parallelism × chunk_size) window instead of materializing.
    """
    md5 = hashlib.md5()
    first = reader.read(chunk_size)
    if len(first) <= inline_limit:
        md5.update(first)
        return [], first, md5.hexdigest()

    chunks: list[FileChunk] = []
    futures = []
    offset = 0
    # captured once: the pool workers' thread-locals do not inherit the
    # calling request's trace context
    trace_ctx = trace.current()

    def assign_one() -> tuple[str, str, str]:
        if fid_pool is not None:
            return fid_pool.take(
                1, collection=collection, replication=replication,
                ttl_seconds=ttl_seconds, disk_type=disk_type,
                writable_volume_count=growth_count,
            )[0]
        return master.assign_batch(
            1, collection=collection, replication=replication,
            ttl_seconds=ttl_seconds, disk_type=disk_type,
            writable_volume_count=growth_count,
        )[0]

    second = reader.read(chunk_size)
    if not second:
        # single-chunk object — the S3 gateway's hot path: put on the
        # calling thread, no executor spin-up/teardown, and the chunk
        # md5 is the cumulative digest copied, not a second pass
        md5.update(first)
        e_tag = md5.copy().hexdigest()
        fid, url, assign_auth = assign_one()
        auth = master.sign_write(fid) or assign_auth
        http_put_chunk(url, fid, first, auth=auth, content_type=mime, trace_ctx=trace_ctx)
        return (
            [
                FileChunk(
                    fid=fid, offset=0, size=len(first),
                    modified_ts_ns=time.time_ns(), e_tag=e_tag,
                )
            ],
            b"",
            md5.hexdigest(),
        )
    # bound the in-flight window: keeps memory flat and, without a
    # client-side signing key, keeps assign-time tokens fresh.  Released
    # by the worker — no per-chunk rescans of the futures list.
    window = threading.BoundedSemaphore(max(1, parallelism) * 2)
    fid_queue: list[tuple[str, str, str]] = []  # (fid, url, assign_auth)

    def next_fid() -> tuple[str, str, str]:
        if not fid_queue:
            if fid_pool is not None:
                # the pool already batches across requests — draw one at
                # a time so a 1-chunk object can't strand a local batch
                fid_queue.extend(
                    fid_pool.take(
                        1, collection=collection, replication=replication,
                        ttl_seconds=ttl_seconds, disk_type=disk_type,
                        writable_volume_count=growth_count,
                    )
                )
            else:
                fid_queue.extend(
                    master.assign_batch(
                        max(1, assign_batch),
                        collection=collection, replication=replication,
                        ttl_seconds=ttl_seconds, disk_type=disk_type,
                        writable_volume_count=growth_count,
                    )
                )
        return fid_queue.pop(0)

    put_errors: list[BaseException] = []  # producer aborts on first failure

    with ThreadPoolExecutor(max_workers=parallelism) as pool:

        def put(url: str, fid: str, data: bytes, assign_auth: str) -> None:
            try:
                # prefer a token minted at send time: the assign-time token
                # lives ~10s, shorter than a large upload's queueing delay
                auth = master.sign_write(fid) or assign_auth
                http_put_chunk(url, fid, data, auth=auth, content_type=mime,
                               trace_ctx=trace_ctx)
            except BaseException as e:
                put_errors.append(e)
                raise
            finally:
                window.release()

        data, pending_next = first, second
        while data and not put_errors:
            md5.update(data)
            # first chunk: the cumulative digest so far IS this chunk's
            # md5 — copy it instead of hashing the same megabytes twice
            chunk_md5 = (
                md5.copy().hexdigest() if offset == 0
                else hashlib.md5(data).hexdigest()
            )
            fid, url, assign_auth = next_fid()
            chunk = FileChunk(
                fid=fid,
                offset=offset,
                size=len(data),
                modified_ts_ns=time.time_ns(),
                e_tag=chunk_md5,
            )
            chunks.append(chunk)
            window.acquire()
            futures.append(pool.submit(put, url, fid, data, assign_auth))
            offset += len(data)
            data = pending_next
            pending_next = reader.read(chunk_size) if data else b""
        for f in futures:
            f.result()  # surface upload errors (incl. the aborting one)
    return chunks, b"", md5.hexdigest()
