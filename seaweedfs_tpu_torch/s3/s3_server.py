"""S3 API gateway: bucket/object CRUD, listings, multipart, over the filer.

Counterpart of the reference's weed/s3api/ (s3api_bucket_handlers.go,
s3api_object_handlers*.go, filer_multipart.go): buckets are directories
under /buckets in the filer, objects are filer entries, multipart parts
are chunk-backed entries whose chunk lists are spliced together at
CompleteMultipartUpload with zero data movement — the same trick the
reference plays with its chunk manifests.

The port's copy of seaweedfs_tpu/s3/s3_server.py.  The gateway launches no
kernel: its objects live in volumes whose servers run the codec.  Object
bodies move through the native splice (filer/splice.py over csrc/dp.cpp's
px verbs, as the JAX package's): a GET relays chunk views volume->client
(hot-chunk cache first), an open-access streaming PUT fans each chunk out
to its holders with the ETag computed in-stream; never under SSE or TLS,
and not with ``SEAWEEDFS_TPU_NATIVE_PX=0``.  A splice library that cannot
be built or loaded fails ``start``.  Every request runs in an edge trace span (a new trace
unless the client sent a ``traceparent``) and records into its op
class's latency sketch (stats/sketch.py); ``tls_cert``/``tls_key`` serve
HTTPS.  ``filer`` may be a ``ShardedFilerClient`` (filer/shard_ring.py): a
dead shard answers 503 SlowDown with Retry-After.  ``credential_store``
(iam/) supplies the identities, refreshed in the background;
``inval_bus`` (filer/inval_bus.py) keeps the caches of a ``-workers``
group coherent.  The browser form POST (s3/post_policy.py) and
SelectObjectContent (query/select.py) answer as the JAX package's do.
"""

from __future__ import annotations

import binascii
import hashlib
import hmac
import io
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from dataclasses import replace

import grpc

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.filer import Filer, reader as chunk_reader, upload as chunk_upload
from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.filer.inval_bus import FID_PREFIX
from seaweedfs_tpu_torch.filer.shard_ring import ShardUnavailable
from seaweedfs_tpu_torch.s3.auth import (
    STREAMING_PAYLOAD,
    AccessDenied,
    Identity,
    SigV4Verifier,
)
from seaweedfs_tpu_torch.stats import sketch, trace
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler, StreamingBody
from seaweedfs_tpu_torch.wdclient import MasterClient

from seaweedfs_tpu_torch.util import wlog

BUCKETS_ROOT = "/buckets"
UPLOADS_DIR = ".uploads"  # per-bucket multipart staging area
VERSIONS_DIR = ".versions"  # per-bucket archived object versions
XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


class S3Error(Exception):
    def __init__(self, status: int, code: str, message: str):
        super().__init__(message)
        self.status = status
        self.code = code


def _no_such_bucket(b):
    return S3Error(404, "NoSuchBucket", f"bucket {b} does not exist")


def _no_such_key(k):
    return S3Error(404, "NoSuchKey", f"key {k} does not exist")


def _xml(root: ET.Element) -> bytes:
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)


def _el(parent, tag, text=None):
    e = ET.SubElement(parent, tag)
    if text is not None:
        e.text = str(text)
    return e


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def decode_aws_chunked(body: bytes, ctx=None, decoded_length: int | None = None) -> bytes:
    """Decode aws-chunked framing (`size;chunk-signature=...\\r\\n<data>\\r\\n`)
    used by SigV4 streaming uploads.

    With a :class:`SigV4Context` (identities configured), every chunk
    signature is verified against the HMAC chain seeded by the request
    signature, including the final zero-length chunk, and the decoded size
    must match ``x-amz-decoded-content-length`` — the reference's
    chunked_reader_v4.go verifyChunk behavior.  Without a context the
    framing is merely stripped (open-access gateway).
    """
    out = bytearray()
    prev_sig = ctx.signature if ctx else ""
    saw_final = False
    i = 0
    while i < len(body):
        nl = body.find(b"\r\n", i)
        if nl < 0:
            if ctx:
                raise AccessDenied("truncated aws-chunked framing")
            break
        header = body[i:nl].decode(errors="replace")
        size_field, _, rest = header.partition(";")
        try:
            size = int(size_field, 16)
        except ValueError as e:
            raise AccessDenied(f"bad chunk size {size_field!r}") from e
        start = nl + 2
        chunk = body[start : start + size]
        if ctx:
            sig = dict(
                p.split("=", 1) for p in rest.split(";") if "=" in p
            ).get("chunk-signature", "")
            if len(chunk) != size:
                raise AccessDenied("truncated chunk body")
            expect = ctx.chunk_signature(prev_sig, bytes(chunk))
            if not hmac.compare_digest(expect, sig):
                raise AccessDenied("chunk signature mismatch")
            prev_sig = expect
        if size == 0:
            saw_final = True
            break
        out += chunk
        i = start + size + 2  # skip trailing \r\n
    if ctx and not saw_final:
        # a body cut off at a chunk boundary parses cleanly — only the
        # signed zero-length terminal chunk proves the stream is complete
        raise AccessDenied("streaming body missing terminal chunk")
    if ctx and decoded_length is not None and len(out) != decoded_length:
        raise AccessDenied(
            f"decoded length {len(out)} != x-amz-decoded-content-length "
            f"{decoded_length}"
        )
    return bytes(out)


class S3AccessLog:
    """S3 access log: one space-separated line per request —
    ``time client method path action status bytes duration_ms trace_id``
    (the reference's s3 -auditLogConfig analogue).  ``path`` is "-" for
    stderr, else a file opened in append mode; lines flush per write so
    `tail -f` works."""

    def __init__(self, path: str):
        import sys

        self.path = path
        self._lock = threading.Lock()
        if path == "-":
            self._fh = sys.stderr
        else:
            self._fh = open(path, "a", buffering=1)  # closed in close()

    def log(
        self, *, client: str, method: str, path: str, action: str,
        status: int, nbytes: int, dur_ms: float, trace_id: str = "",
    ) -> None:
        line = (
            f"{time.strftime('%Y-%m-%dT%H:%M:%S%z')} {client} {method} "
            f"{path} {action} {status} {nbytes} {dur_ms:.2f} {trace_id or '-'}\n"
        )
        with self._lock:
            try:
                self._fh.write(line)
            except (ValueError, OSError):
                # closed file / ENOSPC / EPIPE: the diagnostic log must
                # never take the data path down with it
                pass

    def close(self) -> None:
        import sys

        with self._lock:
            if self._fh is not sys.stderr:
                self._fh.close()


class S3ApiServer:
    """One gateway process: in-process Filer (or a shared one) + HTTP."""

    def __init__(
        self,
        master_address: str,
        *,
        port: int = 0,
        ip: str = "127.0.0.1",
        filer: Filer | None = None,
        identities: dict[str, Identity] | None = None,
        chunk_size: int = chunk_upload.DEFAULT_CHUNK_SIZE,
        kms=None,  # security.kms.KmsProvider for SSE-S3
        credential_store=None,  # iam.CredentialStore: dynamic identities
        credential_refresh: float = 5.0,
        lifecycle_sweep_interval: float = 3600.0,  # 0 disables
        circuit_breaker_config: dict | None = None,
        tls_cert: str = "",  # with tls_key: HTTPS on the gateway's port
        tls_key: str = "",
        access_log: str = "",  # "" disables; "-" = stderr; else file path
        entry_cache_ttl: float = 2.0,  # 0 disables the gateway entry cache
        reuse_port: bool = False,  # SO_REUSEPORT: share the listen address
        inval_bus=None,  # filer/inval_bus.InvalBus: worker-group coherence
        meta_subscribe: bool = True,  # remote filers: event-log invalidation
        qos_config: dict | None = None,  # static tenant QoS (else polled)
        chunk_cache_mb: float | None = None,  # None = WEED_CHUNK_CACHE_MB
    ):
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("the gateway's HTTPS needs both tls_cert and tls_key")
        if tls_cert:
            from seaweedfs_tpu_torch.security.tls import server_ssl_context

            # fail fast, before anything binds: a pair that does not load
            # must never leave a plaintext listener behind
            server_ssl_context(tls_cert, tls_key)
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.access_log = S3AccessLog(access_log) if access_log else None
        self.master = MasterClient(master_address)
        # the embedded single-process gateway IS a deployment shape
        # (weed-tpu s3 with no -filer): one process, its own metadata
        # engine, no shard ring to route through
        self.filer = filer or Filer(master_client=self.master)
        # per-process entry cache for the GET path: TTL-bounded, and
        # invalidated synchronously by this filer's mutation events
        # (filer/entry_cache.py) so repeated GETs skip the filer store.
        # Only enabled when invalidation can actually reach this process:
        # the in-process listener seam covers an embedded filer; a shared
        # (Remote/Sharded) filer additionally needs the metadata-event
        # subscription (filer/meta_subscriber.py) or the worker-group bus,
        # or a PUT through another process could serve the old object for
        # a whole TTL, which S3 clients (and our tests) rightly reject.
        from seaweedfs_tpu_torch.filer.entry_cache import EntryCache

        self.entry_cache = None
        self.reuse_port = reuse_port
        self.inval_bus = inval_bus
        self.meta_subscriber = None
        is_remote = getattr(self.filer, "remote", False)
        cacheable = entry_cache_ttl > 0 and hasattr(self.filer, "listeners")
        if cacheable and is_remote and inval_bus is None and not meta_subscribe:
            # no coherence channel at all for other processes' mutations:
            # keep the pre-cache behavior (meta_subscribe=False is the
            # explicit opt-out for filers whose event log is unreachable)
            cacheable = False
        if cacheable:
            self.entry_cache = EntryCache(
                ttl=entry_cache_ttl,
                # hot missing-key storms are absorbed, while a created
                # object becomes visible within 0.5s even if every
                # invalidation event is lost
                neg_ttl=min(entry_cache_ttl, 0.5),
            )
            self.entry_cache.attach(self.filer)
        # hot-chunk cache tier (util/chunk_cache): S3-FIFO over mmap'd
        # segment files + an in-RAM small-object tier.  Fids are
        # immutable, so a cached body is byte-correct regardless of
        # invalidation delivery; the planes below (listeners / inval bus /
        # metadata stream) only RECLAIM
        # deleted chunks' bytes, with the optional entry TTL as backstop.
        from seaweedfs_tpu_torch.util import chunk_cache as chunk_cache_mod

        if chunk_cache_mb is None:
            self.chunk_cache = chunk_cache_mod.ChunkCache.from_env()
        elif chunk_cache_mb > 0:
            self.chunk_cache = chunk_cache_mod.ChunkCache(
                int(chunk_cache_mb * (1 << 20))
            )
        else:
            self.chunk_cache = None
        if self.chunk_cache is not None:
            chunk_cache_mod.register_debug(self.chunk_cache)
            if hasattr(self.filer, "listeners"):
                self.filer.listeners.append(self._on_entry_event_chunks)
        if is_remote and meta_subscribe and (
            self.entry_cache is not None or self.chunk_cache is not None
        ):
            # cross-process invalidation plane: tail every filer shard's
            # metadata event log (the same stream filer.sync rides) and
            # drop mutated paths; a broken stream clears the cache once
            # (gap) and the TTL bounds the outage window
            from seaweedfs_tpu_torch.filer.meta_subscriber import MetaSubscriber

            addresses = list(
                getattr(self.filer, "shard_addresses", None)
                or [self.filer.address]
            )
            self.meta_subscriber = MetaSubscriber(
                addresses,
                on_paths=self._on_peer_invalidation,
                # a stream gap only threatens the ENTRY cache (a missed
                # mutation could serve stale metadata for a TTL); chunk
                # bodies stay byte-correct — fids are immutable — so the
                # chunk tier keeps its hot set through a blip
                on_gap=(
                    self.entry_cache.clear
                    if self.entry_cache is not None else None
                ),
            )
        if inval_bus is not None:
            # publish this worker's mutations to the sibling workers even
            # with our own cache disabled — they may be caching
            self.filer.listeners.append(self._publish_invalidation)
            if self.entry_cache is not None or self.chunk_cache is not None:
                inval_bus.start(self._on_peer_invalidation)
        # cross-request assign batching: a stream of object PUTs costs
        # ~1/batch of a master round trip each (filer/upload.FidPool)
        self.fid_pool = chunk_upload.FidPool(self.master, native_stash=True)
        self.verifier = SigV4Verifier(
            identities, require_auth=credential_store is not None
        )
        self.kms = kms
        self.credential_store = credential_store
        self.credential_refresh = credential_refresh
        self.lifecycle_sweep_interval = lifecycle_sweep_interval
        self.chunk_size = chunk_size
        self.ip = ip
        self._port = port
        self._httpd: PooledHTTPServer | None = None
        self._stop_refresh = threading.Event()
        self._lock = threading.Lock()
        from seaweedfs_tpu_torch.s3.circuit_breaker import CircuitBreaker
        from seaweedfs_tpu_torch.util.limiter import TenantQos

        self.circuit_breaker = CircuitBreaker(circuit_breaker_config)
        self._static_breaker = circuit_breaker_config is not None
        # tenant/bucket QoS (util/limiter.TenantQos): op-rate admission +
        # write-path quotas, shed with 429 + Retry-After before the
        # metadata plane queues; config static or polled from the filer
        self.qos = TenantQos(qos_config)
        self._static_qos = qos_config is not None
        from seaweedfs_tpu_torch.util import limiter as limiter_mod

        limiter_mod.register_debug(self.qos)
        # bucket -> (expiry, (bytes, objects)): quota enforcement reads
        # usage through a short TTL so a PUT storm costs one tree walk
        # per window, not one per request.  Bucket names arrive in URLs
        # pre-auth, so the cache is capacity-bounded (LRU) like the QoS
        # gate table.
        from collections import OrderedDict

        self._usage_cache: OrderedDict[
            str, tuple[float, tuple[int, int]]
        ] = OrderedDict()
        self.filer.mkdirs(BUCKETS_ROOT)
        if credential_store is not None:
            self.refresh_identities()
        self.refresh_circuit_breaker()
        self.refresh_qos()

    # ---- worker-group cache coherence (filer/inval_bus.py) --------------
    def _publish_invalidation(self, ev) -> None:
        """Filer.listeners hook: fan this worker's mutation out to the
        sibling SO_REUSEPORT workers' caches — entry paths plus any
        retired chunk fids (``fid:`` lines, the hot-chunk tier)."""
        from seaweedfs_tpu_torch.filer.meta_subscriber import event_fids

        paths = [
            e.full_path for e in (ev.old_entry, ev.new_entry) if e is not None
        ]
        if ev.new_parent_path and ev.new_entry is not None:
            name = ev.new_entry.full_path.rsplit("/", 1)[-1]
            paths.append(ev.new_parent_path.rstrip("/") + "/" + name)
        paths += [
            FID_PREFIX + fid for fid in event_fids(ev.old_entry, ev.new_entry)
        ]
        self.inval_bus.publish(paths)

    def _on_peer_invalidation(self, paths: list[str]) -> None:
        """Bus/stream receiver: another mutator touched these — entry
        paths drop from the entry cache, ``fid:`` lines reclaim the
        hot-chunk tier's retired ranges."""
        for p in paths:
            if p.startswith(FID_PREFIX):
                if self.chunk_cache is not None:
                    self.chunk_cache.invalidate_fid(p[len(FID_PREFIX):])
            elif self.entry_cache is not None:
                self.entry_cache.invalidate(p)

    def _on_entry_event_chunks(self, ev) -> None:
        """Filer.listeners hook: reclaim this process's cached ranges of
        chunks the mutation retired (delete / overwrite)."""
        from seaweedfs_tpu_torch.filer.meta_subscriber import event_fids

        for fid in event_fids(ev.old_entry, ev.new_entry):
            self.chunk_cache.invalidate_fid(fid)

    def refresh_identities(self) -> None:
        """Pull the ak->Identity map from the credential store (IAM
        mutations propagate here — reference credential store watch)."""
        if self.credential_store is not None:
            self.verifier.identities = self.credential_store.identity_map()

    def refresh_circuit_breaker(self) -> None:
        """Adopt breaker ceilings from the filer config entry written by
        `s3.circuitbreaker` (reference /etc/s3 circuit_breaker.json watch);
        a static constructor config wins over the filer."""
        if self._static_breaker:
            return
        from seaweedfs_tpu_torch.s3 import circuit_breaker as cb_mod

        e = self.filer.find_entry(cb_mod.CONFIG_PATH)
        if e is not None and e.content:
            self.circuit_breaker.load_json(e.content)
        else:
            # config entry removed (e.g. fs.rm of the json): stale limits
            # must not keep throttling until a gateway restart
            self.circuit_breaker.load({})

    def refresh_qos(self) -> None:
        """Adopt tenant-QoS limits from the filer config entry written by
        `s3.qos` (same polling contract as the circuit breaker)."""
        if self._static_qos:
            return
        from seaweedfs_tpu_torch.util.limiter import QOS_CONFIG_PATH

        e = self.filer.find_entry(QOS_CONFIG_PATH)
        if e is not None and e.content:
            self.qos.load_json(e.content)
        else:
            self.qos.load({})

    _USAGE_TTL = 10.0

    def bucket_usage(self, bucket: str) -> tuple[int, int]:
        """(bytes, objects) currently held under a bucket, cached for
        _USAGE_TTL: quota enforcement is deliberately approximate — a
        burst inside one window can overshoot by that window's writes,
        which beats a full tree walk per PUT (the reference's
        s3_bucket_quota sweep makes the same trade)."""
        now = time.monotonic()
        hit = self._usage_cache.get(bucket)
        if hit is not None and hit[0] > now:
            return hit[1]
        nbytes = nobjects = 0
        stack = [self.bucket_path(bucket)]
        while stack:
            d = stack.pop()
            try:
                entries = self.filer.list_entries(d, limit=100_000)
            except (FilerError, OSError, KeyError):
                entries = []
            for e in entries:
                if e.is_directory:
                    if e.name != UPLOADS_DIR:  # staging parts don't count
                        stack.append(e.full_path)
                else:
                    nbytes += e.size
                    nobjects += 1
        self._usage_cache[bucket] = (now + self._USAGE_TTL, (nbytes, nobjects))
        self._usage_cache.move_to_end(bucket)
        while len(self._usage_cache) > 1024:
            self._usage_cache.popitem(last=False)
        return nbytes, nobjects

    # ---- lifecycle ------------------------------------------------------
    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> None:
        from seaweedfs_tpu_torch.native import dataplane

        dataplane.require_px()  # an enabled splice that cannot load fails here
        handler = type("Handler", (_S3HttpHandler,), {"s3": self})
        self._httpd = PooledHTTPServer(
            (self.ip, self._port), handler, reuse_port=self.reuse_port
        )
        if self.tls_cert:
            from seaweedfs_tpu_torch.security.tls import wrap_http_server

            wrap_http_server(self._httpd, self.tls_cert, self.tls_key)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        if self.meta_subscriber is not None:
            self.meta_subscriber.start()
        if self.credential_refresh > 0 and (
            self.credential_store is not None
            or not self._static_breaker
            or not self._static_qos  # s3.qos edits must still be adopted
        ):

            def refresh_loop():
                while not self._stop_refresh.wait(self.credential_refresh):
                    try:
                        self.refresh_identities()
                    except Exception as e:  # noqa: BLE001 — store blip: keep last map
                        wlog.warning("s3: identity refresh failed, keeping last map: %s", e)
                    try:
                        self.refresh_circuit_breaker()
                    except Exception as e:  # noqa: BLE001 — keep last limits
                        wlog.warning("s3: circuit-breaker refresh failed, keeping last limits: %s", e)
                    try:
                        self.refresh_qos()
                    except Exception as e:  # noqa: BLE001 — keep last limits
                        wlog.warning("s3: qos refresh failed, keeping last limits: %s", e)

            threading.Thread(target=refresh_loop, daemon=True).start()
        if self.lifecycle_sweep_interval > 0:

            def lifecycle_loop():
                while not self._stop_refresh.wait(self.lifecycle_sweep_interval):
                    try:
                        self.apply_lifecycle()
                    except Exception as e:  # noqa: BLE001 — sweep must not die
                        wlog.warning("s3: lifecycle sweep failed: %s", e)

            threading.Thread(target=lifecycle_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop_refresh.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self.meta_subscriber is not None:
            self.meta_subscriber.stop()
        if self.inval_bus is not None:
            self.inval_bus.close()
        if self.chunk_cache is not None:
            self.chunk_cache.close()
        # the filer client (router/RemoteFiler) is caller-owned: a
        # router shared across gateways must survive one gateway's stop
        if self.access_log is not None:
            self.access_log.close()

    # ---- bucket ops -----------------------------------------------------
    def bucket_path(self, bucket: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}"

    def find_entry_cached(self, path: str) -> Entry | None:
        """Read-path entry lookup through the gateway cache (mutating
        paths keep calling ``self.filer.find_entry`` directly)."""
        if self.entry_cache is None:
            return self.filer.find_entry(path)
        return self.entry_cache.get(path, self.filer.find_entry)

    def require_bucket(self, bucket: str) -> Entry:
        e = self.find_entry_cached(self.bucket_path(bucket))
        if e is None or not e.is_directory:
            raise _no_such_bucket(bucket)
        return e

    def list_buckets(self) -> bytes:
        root = ET.Element("ListAllMyBucketsResult", xmlns=XMLNS)
        owner = _el(root, "Owner")
        _el(owner, "ID", "weedtpu")
        buckets = _el(root, "Buckets")
        for e in self.filer.list_entries(BUCKETS_ROOT, limit=10_000):
            if e.is_directory and not e.name.startswith("."):
                b = _el(buckets, "Bucket")
                _el(b, "Name", e.name)
                _el(b, "CreationDate", _iso(e.attr.crtime))
        return _xml(root)

    def create_bucket(self, bucket: str) -> None:
        if self.filer.find_entry(self.bucket_path(bucket)) is not None:
            raise S3Error(409, "BucketAlreadyExists", bucket)
        self.filer.create_entry(
            Entry(self.bucket_path(bucket), is_directory=True, attr=Attr.now(0o755))
        )

    def delete_bucket(self, bucket: str) -> None:
        self.require_bucket(bucket)
        children = [
            e
            for e in self.filer.list_entries(self.bucket_path(bucket), limit=1000)
            if e.name not in (UPLOADS_DIR, VERSIONS_DIR)
        ]
        if children or not self._tree_has_no_files(
            self.versions_path(bucket, "").rstrip("/")
        ):
            # archived versions make the bucket non-empty (AWS requires
            # deleting every version first); leftover empty .versions
            # directories don't
            raise S3Error(409, "BucketNotEmpty", bucket)
        self.filer.delete_entry(self.bucket_path(bucket), recursive=True)

    def _tree_has_no_files(self, dir_path: str) -> bool:
        for e in self.filer.list_entries(dir_path, limit=100_000):
            if not e.is_directory:
                return False
            if not self._tree_has_no_files(e.full_path):
                return False
        return True

    # ---- bucket configuration (policy / cors / versioning) --------------
    def bucket_config(self, bucket: str, name: str) -> bytes | None:
        e = self.require_bucket(bucket)
        return e.extended.get(name)

    def set_bucket_config(self, bucket: str, name: str, value: bytes | None) -> None:
        e = self.require_bucket(bucket)
        if value is None:
            e.extended.pop(name, None)
        else:
            e.extended[name] = value
        self.filer.update_entry(e)

    def bucket_policy_doc(self, bucket: str) -> dict | None:
        try:
            return _parse_policy_blob(self.bucket_config(bucket, "policy"))
        except S3Error:
            return None

    def cors_rules(self, bucket: str):
        try:
            return _parse_cors_blob(self.bucket_config(bucket, "cors"))
        except S3Error:
            return None

    def versioning_state(self, bucket: str) -> str:
        return (self.bucket_config(bucket, "versioning") or b"").decode()

    # ---- object ops -----------------------------------------------------
    def object_path(self, bucket: str, key: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}/{key}"

    def versions_path(self, bucket: str, key: str, version_id: str = "") -> str:
        base = f"{BUCKETS_ROOT}/{bucket}/{VERSIONS_DIR}/{key}"
        return f"{base}/{version_id}" if version_id else base

    @staticmethod
    def _new_version_id() -> str:
        # time-ordered so lexicographic max = newest (promote-on-delete)
        return f"{time.time_ns():020x}{uuid.uuid4().hex[:8]}"

    @staticmethod
    def _version_order(name: str):
        """Sort key for version ids: the literal 'null' id (pre-versioning
        or suspended-mode content) is oldest, despite 'n' sorting above
        hex digits."""
        return (0, "") if name == "null" else (1, name)

    def _archive_version(self, bucket: str, key: str, entry: Entry) -> None:
        """Copy the live entry's metadata into the versions tree (chunks
        stay put, shared).  Insert-only — the live entry is left intact so
        a failure in the caller's subsequent create_entry cannot leave the
        key without a live object; the create that follows overwrites the
        live slot atomically at the store layer."""
        vid = (entry.extended.get("version_id") or b"null").decode()
        archived = replace(
            entry, full_path=self.versions_path(bucket, key, vid)
        )
        self.filer.create_entry(archived)

    @staticmethod
    def check_key(key: str) -> str:
        head = key.split("/", 1)[0]
        if head in (UPLOADS_DIR, VERSIONS_DIR):
            raise S3Error(400, "InvalidRequest", f"{head}/ is a reserved prefix")
        return key

    def put_object(
        self, bucket: str, key: str, body, mime: str, meta: dict[str, bytes]
    ) -> tuple[str, str]:
        """Returns (etag, version_id) — version_id empty when unversioned.
        ``body`` is bytes or a file-like reader: the gateway hands the
        request socket straight in so the object streams through the
        uploader's bounded window instead of materializing."""
        self.require_bucket(bucket)
        self.check_key(key)
        if key.endswith("/"):
            self.filer.mkdirs(self.object_path(bucket, key.rstrip("/")))
            return hashlib.md5(b"").hexdigest(), ""
        reader = io.BytesIO(body) if isinstance(body, (bytes, bytearray)) else body
        from seaweedfs_tpu_torch.filer import splice as native_splice

        # native PUT splice: a streaming body relays client->volume(s) with
        # the MD5 ETag computed in-stream (None: not applicable, or no
        # holder reachable with the socket untouched; the Python path
        # below replays it either way)
        spliced = native_splice.try_put_splice(
            self.master, reader, fid_pool=self.fid_pool,
            chunk_size=self.chunk_size, mime=mime,
        )
        if spliced is not None:
            chunks, content, etag = spliced
        else:
            chunks, content, etag = chunk_upload.upload_stream(
                self.master, reader, chunk_size=self.chunk_size,
                fid_pool=self.fid_pool,
            )
        state = self.versioning_state(bucket)
        extended = {"etag": etag.encode(), **meta}
        if state == "Enabled":
            extended["version_id"] = self._new_version_id().encode()
        elif state == "Suspended":
            extended["version_id"] = b"null"
        entry = Entry(
            self.object_path(bucket, key),
            attr=Attr.now(mime=mime),
            chunks=chunks,
            content=content,
            extended=extended,
        )
        # insert first, reclaim superseded chunks after: a concurrent GET
        # that resolved the old entry must not read deleted fids, and a
        # failed insert must not orphan the existing object's data
        old = self.filer.find_entry(entry.full_path)
        if old is not None and not old.is_directory and self._should_archive(state, old):
            self._archive_version(bucket, key, old)  # keep bytes as a version
            old = None
        self.filer.create_entry(entry)
        if old is not None and not old.is_directory:
            self.filer._delete_chunks(old)
        return etag, (extended.get("version_id") or b"").decode()

    @staticmethod
    def _should_archive(state: str, old: Entry) -> bool:
        """Enabled: archive everything.  Suspended: AWS preserves real
        (non-null) versions and only overwrites the null one in place."""
        if state == "Enabled":
            return True
        if state == "Suspended":
            return (old.extended.get("version_id") or b"null") != b"null"
        return False

    def resolve_copy_source(self, source: str):
        """x-amz-copy-source header -> (src_bucket, src_key, entry).
        One resolution path for CopyObject and UploadPartCopy; delete
        markers 404."""
        src = urllib.parse.unquote(source.lstrip("/"))
        src_bucket, _, src_key = src.partition("/")
        src_entry = self.get_object_entry(src_bucket, src_key)
        return src_bucket, src_key, src_entry

    def read_source_plain(
        self, src_entry: Entry, headers, offset: int = 0, size: int = -1
    ) -> bytes:
        """Source bytes for a copy, decrypted when the source is SSE
        (SSE-C keys arrive as x-amz-copy-source-sse-c-* headers; ranges
        slice the PLAINTEXT — whole-object GCM cannot serve a ciphertext
        slice).  Reference s3_sse_c.go copy-source handling."""
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        if not sse_mod.is_encrypted(src_entry.extended):
            return chunk_reader.read_entry(self.master, src_entry, offset, size)
        sealed = chunk_reader.read_entry(self.master, src_entry)
        try:
            plain, _ = sse_mod.decrypt_for_get(
                sse_mod.copy_source_view(headers), src_entry.extended,
                sealed, self.kms,
            )
        except sse_mod.SseError as e:
            raise S3Error(e.status, e.code, str(e)) from e
        if size < 0:
            return plain[offset:]
        return plain[offset : offset + size]

    # SSE metadata never follows a copy: the destination is re-encrypted
    # (or stored plain) under ITS OWN request headers — stale envelope
    # metadata on a plaintext copy would serve garbage.  Built from the
    # sse module's constants so a new META_* key cannot silently leak
    # through the copy path.
    from seaweedfs_tpu_torch.s3 import sse as _sse_mod

    _SSE_META_KEYS = tuple(
        v
        for k, v in vars(_sse_mod).items()
        if k.startswith("META_")
    )
    del _sse_mod

    def copy_object(
        self, bucket: str, key: str, source: str, headers=None
    ) -> tuple[str, float]:
        """x-amz-copy-source: server-side copy.  The data is re-uploaded
        to fresh chunks (like the reference's CopyObject) — sharing fids
        between entries would corrupt the survivor when either object is
        deleted, since chunks carry no reference counts.  An SSE source
        is decrypted with the copy-source key headers; SSE request
        headers re-encrypt the destination (key re-wrap on copy,
        reference s3_sse_c.go / s3_sse_kms.go)."""
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        _sb, src_key, src_entry = self.resolve_copy_source(source)
        headers = headers or {}
        body = self.read_source_plain(src_entry, headers)
        try:
            body, sse_meta, _hdrs = sse_mod.encrypt_for_put(
                headers, body, self.kms
            )
        except sse_mod.SseError as e:
            raise S3Error(e.status, e.code, str(e)) from e
        etag, _vid = self.put_object(
            bucket,
            key,
            body,
            src_entry.attr.mime,
            {
                **{
                    k: v
                    for k, v in src_entry.extended.items()
                    # object-lock state never follows a copy (AWS: the
                    # copy is a NEW object; inherited WORM would
                    # manufacture locks); SSE metadata is re-derived
                    if k not in (
                        "etag", "version_id", "delete_marker", "acl",
                        "acl_grants",  # ACLs never follow a copy (AWS)
                        self.RETENTION_MODE, self.RETENTION_UNTIL,
                        self.LEGAL_HOLD, *self._SSE_META_KEYS,
                    )
                },
                **sse_meta,
            },
        )
        return etag, time.time()

    def get_object_entry(self, bucket: str, key: str, version_id: str = "") -> Entry:
        self.require_bucket(bucket)
        live = self.find_entry_cached(self.object_path(bucket, key))
        if version_id:
            if (
                live is not None
                and (live.extended.get("version_id") or b"null").decode()
                == version_id
            ):
                e = live
            else:
                e = self.find_entry_cached(self.versions_path(bucket, key, version_id))
            if e is None or e.is_directory:
                raise S3Error(404, "NoSuchVersion", f"{key}@{version_id}")
            if e.extended.get("delete_marker"):
                raise S3Error(405, "MethodNotAllowed", "version is a delete marker")
            return e
        if live is None or live.is_directory:
            raise _no_such_key(key)
        if live.extended.get("delete_marker"):
            raise S3Error(404, "NoSuchKey", f"{key} (delete marker)")
        return live

    def delete_object(self, bucket: str, key: str) -> str:
        """Unversioned: remove.  Versioning enabled/suspended: archive the
        live entry (suspended keeps only non-null versions) and leave a
        delete marker as the latest version (reference
        s3api_object_versioning.go semantics).  Returns the marker's
        version id, '' otherwise."""
        self.require_bucket(bucket)
        state = self.versioning_state(bucket)
        if state in ("Enabled", "Suspended"):
            self.check_key(key)
            live = self.filer.find_entry(self.object_path(bucket, key))
            if live is not None and live.is_directory:
                raise S3Error(409, "InvalidRequest", f"{key} is a prefix")
            archived = False
            if live is not None and self._should_archive(state, live):
                self._archive_version(bucket, key, live)
                archived = True
            vid = self._new_version_id() if state == "Enabled" else "null"
            # the marker overwrites the live slot in one insert; only then
            # is a replaced suspended-null version's data reclaimed
            self.filer.create_entry(
                Entry(
                    self.object_path(bucket, key),
                    attr=Attr.now(),
                    extended={
                        "delete_marker": b"1",
                        "version_id": vid.encode(),
                    },
                )
            )
            if live is not None and not archived:
                self.filer._delete_chunks(live)
            return vid
        try:
            self.filer.delete_entry(self.object_path(bucket, key), recursive=False)
        except FileNotFoundError:
            pass  # S3 delete is idempotent
        except FilerError:
            raise S3Error(409, "InvalidRequest", f"{key} is a non-empty prefix")
        return ""

    def delete_object_version(
        self,
        bucket: str,
        key: str,
        version_id: str,
        *,
        bypass_governance: bool = False,
        authenticated: bool = True,
    ) -> None:
        """Remove one specific version.  Deleting the live/latest version
        promotes the newest archived one back to the live path.  WORM
        enforcement happens here on the one entry fetch (delete markers
        are never locked; missing versions stay an idempotent no-op)."""
        self.require_bucket(bucket)
        live = self.filer.find_entry(self.object_path(bucket, key))
        live_vid = (
            (live.extended.get("version_id") or b"null").decode() if live else ""
        )
        if live is not None and live_vid == version_id:
            if not live.extended.get("delete_marker"):
                self.check_object_lock(live, bypass_governance, authenticated)
            self.filer.delete_entry(self.object_path(bucket, key), recursive=False)
            self._promote_newest_version(bucket, key)
            return
        vpath = self.versions_path(bucket, key, version_id)
        v = self.filer.find_entry(vpath)
        if v is None:
            return  # idempotent, like unversioned delete
        if not v.extended.get("delete_marker"):
            self.check_object_lock(v, bypass_governance, authenticated)
        try:
            self.filer.delete_entry(vpath, recursive=False)
        except FileNotFoundError:
            pass

    def _promote_newest_version(self, bucket: str, key: str) -> None:
        vdir = self.versions_path(bucket, key)
        versions = [
            e
            for e in self.filer.list_entries(vdir, limit=100_000)
            if not e.is_directory
        ]
        if not versions:
            return
        newest = max(versions, key=lambda e: self._version_order(e.name))
        self.filer.rename(newest.full_path, self.object_path(bucket, key))

    def list_object_versions(
        self,
        bucket: str,
        *,
        prefix: str = "",
        max_keys: int = 1000,
        key_marker: str = "",
        version_id_marker: str = "",
    ) -> bytes:
        self.require_bucket(bucket)
        root = ET.Element("ListVersionsResult", xmlns=XMLNS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        _el(root, "MaxKeys", max_keys)
        if key_marker:
            _el(root, "KeyMarker", key_marker)
        if version_id_marker:
            _el(root, "VersionIdMarker", version_id_marker)
        truncated = _el(root, "IsTruncated", "false")
        emitted = 0
        last: tuple[str, str] = ("", "")
        # resume is seeded into the walk (O(page), not O(bucket)); within
        # the marker key, rows at or above the version-id marker's order
        # are skipped — comparing by order, not equality, so a marker
        # version deleted between pages can't swallow the rest of the key
        in_marker_key = bool(key_marker and version_id_marker)
        marker_rank = self._version_order(version_id_marker) if in_marker_key else None
        for key, live in self.walk_keys(
            bucket,
            prefix,
            after=key_marker,
            include_markers=True,
            after_inclusive=in_marker_key,
        ):
            skipping = in_marker_key and key == key_marker
            rows: list[tuple[Entry, bool]] = [(live, True)]
            vdir = self.versions_path(bucket, key)
            archived = [
                e
                for e in self.filer.list_entries(vdir, limit=100_000)
                if not e.is_directory
            ]
            for e in sorted(
                archived, key=lambda e: self._version_order(e.name), reverse=True
            ):
                rows.append((e, False))
            for e, is_latest in rows:
                vid = (e.extended.get("version_id") or b"null").decode()
                if skipping:
                    if vid == version_id_marker:
                        skipping = False
                        continue  # the marker row itself was already served
                    if self._version_order(vid) < marker_rank:
                        skipping = False  # older than the (vanished) marker
                    else:
                        continue
                if emitted >= max_keys:
                    truncated.text = "true"
                    _el(root, "NextKeyMarker", last[0])
                    _el(root, "NextVersionIdMarker", last[1])
                    return _xml(root)
                if e.extended.get("delete_marker"):
                    m = _el(root, "DeleteMarker")
                else:
                    from seaweedfs_tpu_torch.s3 import sse as sse_mod

                    m = _el(root, "Version")
                    _el(m, "ETag", f'"{(e.extended.get("etag") or b"").decode()}"')
                    _el(m, "Size", sse_mod.display_size(e.extended, e.size))
                    _el(m, "StorageClass", "STANDARD")
                _el(m, "Key", key)
                _el(m, "VersionId", vid)
                _el(m, "IsLatest", "true" if is_latest else "false")
                _el(m, "LastModified", _iso(e.attr.mtime))
                emitted += 1
                last = (key, vid)
        return _xml(root)

    # ---- listings -------------------------------------------------------
    def walk_keys(
        self,
        bucket: str,
        prefix: str,
        after: str = "",
        include_markers: bool = False,
        after_inclusive: bool = False,
    ):
        """Yield (key, entry) for matching objects in key order, pruning
        subtrees that cannot contain the prefix and seeding each directory
        scan past ``after`` so paginated listings are O(page), not O(bucket).
        Delete markers are hidden unless ``include_markers``;
        ``after_inclusive`` re-yields the ``after`` key itself (version
        listings resume *within* their marker key)."""
        yield from self._prefix_walk(
            self.bucket_path(bucket), "", prefix, after, include_markers,
            after_inclusive,
        )

    def _prefix_walk(
        self,
        dir_path: str,
        key_prefix: str,
        prefix: str,
        after: str,
        include_markers: bool = False,
        after_inclusive: bool = False,
    ):
        start = ""
        if after and after.startswith(key_prefix):
            # resume inside this directory at the segment containing `after`
            start = after[len(key_prefix) :].split("/", 1)[0]
        for e in self.filer.list_entries(
            dir_path, start_file_name=start, inclusive=True, limit=1_000_000
        ):
            if key_prefix == "" and e.name in (UPLOADS_DIR, VERSIONS_DIR):
                continue
            key = key_prefix + e.name
            if e.is_directory:
                subtree = key + "/"
                if after and subtree <= after and not after.startswith(subtree):
                    continue  # whole subtree precedes the resume point
                # recurse only if the subtree can contain matching keys
                if subtree.startswith(prefix[: len(subtree)]) or prefix.startswith(
                    subtree
                ):
                    yield from self._prefix_walk(
                        e.full_path, subtree, prefix, after, include_markers,
                        after_inclusive,
                    )
            elif key.startswith(prefix) and not (
                after and (key < after if after_inclusive else key <= after)
            ):
                if include_markers or not e.extended.get("delete_marker"):
                    yield key, e

    def list_objects(
        self,
        bucket: str,
        *,
        prefix: str = "",
        delimiter: str = "",
        max_keys: int = 1000,
        start_after: str = "",
        v2: bool = True,
        continuation: str = "",
    ) -> bytes:
        self.require_bucket(bucket)
        after = continuation or start_after
        contents: list[tuple[str, Entry]] = []
        common: set[str] = set()
        truncated = False
        next_token = ""
        last_emitted = ""
        for key, e in self.walk_keys(bucket, prefix, after):
            if delimiter:
                rest = key[len(prefix) :]
                d = rest.find(delimiter)
                if d >= 0:
                    cp = prefix + rest[: d + len(delimiter)]
                    if after and cp <= after:
                        continue  # rolled up on a previous page
                    if cp not in common:
                        if len(contents) + len(common) >= max_keys:
                            truncated, next_token = True, last_emitted
                            break
                        common.add(cp)
                        last_emitted = cp
                    continue
            if len(contents) + len(common) >= max_keys:
                truncated, next_token = True, last_emitted
                break
            contents.append((key, e))
            last_emitted = key

        root = ET.Element("ListBucketResult", xmlns=XMLNS)
        _el(root, "Name", bucket)
        _el(root, "Prefix", prefix)
        if delimiter:
            _el(root, "Delimiter", delimiter)
        _el(root, "MaxKeys", max_keys)
        if v2:
            _el(root, "KeyCount", len(contents) + len(common))
        _el(root, "IsTruncated", "true" if truncated else "false")
        if truncated and v2:
            _el(root, "NextContinuationToken", next_token)
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        for key, e in contents:
            c = _el(root, "Contents")
            _el(c, "Key", key)
            _el(c, "LastModified", _iso(e.attr.mtime))
            _el(c, "ETag", f'"{(e.extended.get("etag") or b"").decode()}"')
            _el(c, "Size", sse_mod.display_size(e.extended, e.size))
            _el(c, "StorageClass", "STANDARD")
        for cp in sorted(common):
            p = _el(root, "CommonPrefixes")
            _el(p, "Prefix", cp)
        return _xml(root)

    # ---- multipart ------------------------------------------------------
    def upload_dir(self, bucket: str, upload_id: str) -> str:
        return f"{BUCKETS_ROOT}/{bucket}/{UPLOADS_DIR}/{upload_id}"

    def create_multipart(
        self, bucket: str, key: str, mime: str, canned_acl: str = "",
        sse_meta: dict[str, bytes] | None = None,
    ) -> bytes:
        self.require_bucket(bucket)
        self.check_key(key)
        if canned_acl:
            self.validate_canned_acl(canned_acl)
        upload_id = uuid.uuid4().hex
        extended = {"key": key.encode(), "mime": mime.encode()}
        if sse_meta:
            # the upload's SSE parameters (algo + key material) ride the
            # staging directory; every part encrypts under them
            extended.update(sse_meta)
        if canned_acl and canned_acl != "private":
            extended["acl"] = canned_acl.encode()
        self.filer.create_entry(
            Entry(
                self.upload_dir(bucket, upload_id),
                is_directory=True,
                attr=Attr.now(0o755),
                extended=extended,
            )
        )
        root = ET.Element("InitiateMultipartUploadResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "UploadId", upload_id)
        return _xml(root)

    def _upload_entry(self, bucket: str, upload_id: str) -> Entry:
        e = self.filer.find_entry(self.upload_dir(bucket, upload_id))
        if e is None:
            raise S3Error(404, "NoSuchUpload", upload_id)
        return e

    def put_part(
        self, bucket: str, upload_id: str, part: int, body: bytes,
        headers=None,
    ) -> str:
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        up = self._upload_entry(bucket, upload_id)
        part_meta: dict[str, bytes] = {}
        if sse_mod.is_encrypted(up.extended):
            # per-part envelope under the upload's SSE parameters
            # (reference multipart SSE: each part sealed independently)
            try:
                body, part_meta = sse_mod.encrypt_part(
                    up.extended, headers or {}, body, self.kms
                )
            except sse_mod.SseError as e:
                raise S3Error(e.status, e.code, str(e)) from e
        elif headers is not None and sse_mod.has_sse_headers(headers):
            # SSE headers on a part of an upload CREATED without SSE:
            # storing plaintext the client believes is encrypted is the
            # one silent failure this layer must never allow (AWS
            # rejects parameters that differ from creation time)
            raise S3Error(
                400, "InvalidRequest",
                "upload was not initiated with server-side encryption",
            )
        chunks, _, etag = chunk_upload.upload_stream(
            self.master, io.BytesIO(body), chunk_size=self.chunk_size,
            inline_limit=0, fid_pool=self.fid_pool,
        )
        path = f"{self.upload_dir(bucket, upload_id)}/{part:05d}.part"
        old = self.filer.find_entry(path)
        if old is not None:  # retried part: reclaim the earlier attempt
            self.filer._delete_chunks(old)
        self.filer.create_entry(
            Entry(
                path, attr=Attr.now(), chunks=chunks,
                extended={"etag": etag.encode(), **part_meta},
            )
        )
        return etag

    def complete_multipart(
        self, bucket: str, key: str, upload_id: str, manifest: bytes = b""
    ) -> bytes:
        """Splice part chunk lists into the final object — zero data copy.
        ``manifest`` is the client's CompleteMultipartUpload XML; only the
        parts it commits are spliced, and claimed ETags must match."""
        self.check_key(key)  # else a crafted key writes into .uploads/
        up = self._upload_entry(bucket, upload_id)
        staged = {
            e.name: e
            for e in self.filer.list_entries(
                self.upload_dir(bucket, upload_id), limit=100_000
            )
            if e.name.endswith(".part")
        }
        parts = self._committed_parts(staged, manifest)
        if not parts:
            raise S3Error(400, "InvalidRequest", "no parts uploaded")
        merged: list[FileChunk] = []
        offset = 0
        md5_of_md5s = hashlib.md5()
        for p in parts:
            md5_of_md5s.update(
                binascii.unhexlify((p.extended.get("etag") or b"").decode() or "00")
            )
            for c in sorted(p.chunks, key=lambda c: c.offset):
                merged.append(replace(c, offset=offset + c.offset))
            offset += p.size
        etag = f"{md5_of_md5s.hexdigest()}-{len(parts)}"
        mime = (up.extended.get("mime") or b"").decode()
        state = self.versioning_state(bucket)
        extended = {"etag": etag.encode()}
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        if sse_mod.is_encrypted(up.extended):
            # the completed object is the parts' ciphertext in order;
            # record the segment table GET decrypts by
            extended.update(
                sse_mod.completed_sse_meta(
                    up.extended,
                    [
                        {
                            sse_mod.META_NONCE: p.extended.get(
                                sse_mod.META_NONCE, b""
                            ),
                            sse_mod.META_PLAIN_SIZE: p.extended.get(
                                sse_mod.META_PLAIN_SIZE, b""
                            ),
                        }
                        for p in parts
                    ],
                    [p.size for p in parts],
                )
            )
        if up.extended.get("acl"):
            # --acl given at CreateMultipartUpload applies to the object
            extended["acl"] = up.extended["acl"]
        if state == "Enabled":
            extended["version_id"] = self._new_version_id().encode()
        elif state == "Suspended":
            extended["version_id"] = b"null"
        entry = Entry(
            self.object_path(bucket, key),
            attr=Attr.now(mime=mime),
            chunks=merged,
            extended=extended,
        )
        old = self.filer.find_entry(entry.full_path)
        if old is not None and not old.is_directory and self._should_archive(state, old):
            self._archive_version(bucket, key, old)
            old = None
        self.filer.create_entry(entry)
        if old is not None and not old.is_directory:
            self.filer._delete_chunks(old)
        # reclaim parts the manifest did not commit, then drop staging
        # metadata while keeping the chunks the object now owns
        committed = {id(p) for p in parts}
        for e in staged.values():
            if id(e) not in committed:
                self.filer._delete_chunks(e)
        self.filer.delete_entry(
            self.upload_dir(bucket, upload_id), recursive=True, delete_data=False
        )
        root = ET.Element("CompleteMultipartUploadResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key)
        _el(root, "ETag", f'"{etag}"')
        return _xml(root)

    @staticmethod
    def _committed_parts(staged: dict[str, Entry], manifest: bytes) -> list[Entry]:
        """Resolve the client's part manifest against staged part entries.
        An empty manifest (lenient mode) commits every staged part."""
        if not manifest.strip():
            return [staged[n] for n in sorted(staged)]
        try:
            req = ET.fromstring(manifest.decode())
        except ET.ParseError as e:
            raise S3Error(400, "MalformedXML", str(e)) from e
        ns = {"s3": XMLNS} if req.tag.startswith("{") else {}

        def find(el, tag):
            return el.findtext(f"s3:{tag}", namespaces=ns) if ns else el.findtext(tag)

        parts: list[Entry] = []
        part_els = req.findall("s3:Part", namespaces=ns) if ns else req.findall("Part")
        for pe in part_els:
            num = int(find(pe, "PartNumber") or 0)
            claimed = (find(pe, "ETag") or "").strip('"')
            entry = staged.get(f"{num:05d}.part")
            if entry is None:
                raise S3Error(400, "InvalidPart", f"part {num} was not uploaded")
            actual = (entry.extended.get("etag") or b"").decode()
            if claimed and claimed != actual:
                raise S3Error(400, "InvalidPart", f"part {num} etag mismatch")
            parts.append(entry)
        return parts

    def abort_multipart(self, bucket: str, upload_id: str) -> None:
        self._upload_entry(bucket, upload_id)
        self.filer.delete_entry(
            self.upload_dir(bucket, upload_id), recursive=True, delete_data=True
        )

    def list_parts(self, bucket: str, key: str, upload_id: str) -> bytes:
        """ListParts (reference s3api_object_multipart_handlers.go)."""
        up = self._upload_entry(bucket, upload_id)
        root = ET.Element("ListPartsResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "Key", key or (up.extended.get("key") or b"").decode())
        _el(root, "UploadId", upload_id)
        _el(root, "IsTruncated", "false")
        for e in self.filer.list_entries(
            self.upload_dir(bucket, upload_id), limit=100_000
        ):
            if not e.name.endswith(".part"):
                continue
            p = _el(root, "Part")
            _el(p, "PartNumber", int(e.name[:-5]))
            _el(p, "ETag", f'"{(e.extended.get("etag") or b"").decode()}"')
            _el(p, "Size", e.size)
            _el(p, "LastModified", _iso(e.attr.mtime))
        return _xml(root)

    def list_multipart_uploads(self, bucket: str) -> bytes:
        self.require_bucket(bucket)
        root = ET.Element("ListMultipartUploadsResult", xmlns=XMLNS)
        _el(root, "Bucket", bucket)
        _el(root, "IsTruncated", "false")
        uploads_dir = f"{BUCKETS_ROOT}/{bucket}/{UPLOADS_DIR}"
        for e in self.filer.list_entries(uploads_dir, limit=100_000):
            if not e.is_directory:
                continue
            u = _el(root, "Upload")
            _el(u, "Key", (e.extended.get("key") or b"").decode())
            _el(u, "UploadId", e.name)
            _el(u, "Initiated", _iso(e.attr.crtime))
        return _xml(root)

    def upload_part_copy(
        self, bucket: str, upload_id: str, part: int, source: str,
        crange: str, headers=None,
    ) -> tuple[str, float]:
        """UploadPartCopy: a part sourced from an existing object, with an
        optional x-amz-copy-source-range.  SSE sources decrypt via the
        copy-source key headers; an SSE upload re-encrypts the part."""
        self._upload_entry(bucket, upload_id)
        _sb, _sk, src_entry = self.resolve_copy_source(source)
        offset, size = 0, -1
        if crange:
            m = crange.replace("bytes=", "", 1).split("-")
            try:
                offset = int(m[0])
                size = int(m[1]) - offset + 1
            except (ValueError, IndexError):
                raise S3Error(400, "InvalidArgument", f"bad range {crange!r}")
            if offset < 0 or size <= 0:
                # a reversed range must not fall into read_entry's
                # "negative size = rest of file" convention
                raise S3Error(400, "InvalidArgument", f"bad range {crange!r}")
        body = self.read_source_plain(src_entry, headers or {}, offset, size)
        etag = self.put_part(bucket, upload_id, part, body, headers=headers)
        return etag, time.time()

    # ---- object lock: retention + legal hold -----------------------------
    # (reference s3api object-lock/retention handlers: WORM protection on
    # versioned buckets; GOVERNANCE is bypassable by authorized callers,
    # COMPLIANCE is not)
    RETENTION_MODE = "retention-mode"  # b"GOVERNANCE" | b"COMPLIANCE"
    RETENTION_UNTIL = "retention-until"  # unix seconds, stringified
    LEGAL_HOLD = "legal-hold"  # b"ON"

    def put_retention(
        self,
        bucket: str,
        key: str,
        version_id: str,
        body: bytes,
        bypass_governance: bool = False,
    ) -> None:
        if self.versioning_state(bucket) != "Enabled":
            raise S3Error(
                400, "InvalidRequest", "object lock requires a versioned bucket"
            )
        entry = self.get_object_entry(bucket, key, version_id)
        mode, until = _parse_retention_xml(body)
        existing_mode = entry.extended.get(self.RETENTION_MODE)
        existing_until = int(entry.extended.get(self.RETENTION_UNTIL, b"0"))
        active = time.time() < existing_until
        weakening = until < existing_until or (
            existing_mode == b"COMPLIANCE" and mode != "COMPLIANCE"
        )
        if active and weakening:
            if existing_mode == b"COMPLIANCE":
                # COMPLIANCE can neither shorten NOR downgrade — ever
                raise S3Error(
                    403, "AccessDenied", "COMPLIANCE retention cannot weaken"
                )
            if not bypass_governance:
                # shortening GOVERNANCE needs the explicit bypass intent
                raise S3Error(
                    403, "AccessDenied",
                    "shortening GOVERNANCE retention requires "
                    "x-amz-bypass-governance-retention",
                )
        entry.extended[self.RETENTION_MODE] = mode.encode()
        entry.extended[self.RETENTION_UNTIL] = str(until).encode()
        self.filer.update_entry(entry)

    def get_retention(self, bucket: str, key: str, version_id: str) -> bytes:
        entry = self.get_object_entry(bucket, key, version_id)
        mode = entry.extended.get(self.RETENTION_MODE)
        if not mode:
            raise S3Error(
                404, "NoSuchObjectLockConfiguration", "no retention on object"
            )
        root = ET.Element("Retention", xmlns=XMLNS)
        _el(root, "Mode", mode.decode())
        until = int(entry.extended.get(self.RETENTION_UNTIL, b"0"))
        _el(root, "RetainUntilDate", _iso(until))
        return _xml(root)

    def put_legal_hold(self, bucket: str, key: str, version_id: str, body: bytes) -> None:
        if self.versioning_state(bucket) != "Enabled":
            # only the versioned delete path enforces holds; accepting one
            # on an unversioned object would claim protection it can't give
            raise S3Error(
                400, "InvalidRequest", "object lock requires a versioned bucket"
            )
        entry = self.get_object_entry(bucket, key, version_id)
        status = _parse_status_xml(body, "LegalHold")
        if status == "ON":
            entry.extended[self.LEGAL_HOLD] = b"ON"
        else:
            entry.extended.pop(self.LEGAL_HOLD, None)
        self.filer.update_entry(entry)

    def get_legal_hold(self, bucket: str, key: str, version_id: str) -> bytes:
        entry = self.get_object_entry(bucket, key, version_id)
        root = ET.Element("LegalHold", xmlns=XMLNS)
        _el(
            root,
            "Status",
            "ON" if entry.extended.get(self.LEGAL_HOLD) == b"ON" else "OFF",
        )
        return _xml(root)

    def check_object_lock(
        self, entry: Entry, bypass_governance: bool, authenticated: bool
    ) -> None:
        """Raise when WORM protection forbids destroying this version."""
        if entry.extended.get(self.LEGAL_HOLD) == b"ON":
            raise S3Error(403, "AccessDenied", "object is under legal hold")
        mode = entry.extended.get(self.RETENTION_MODE)
        if not mode:
            return
        until = int(entry.extended.get(self.RETENTION_UNTIL, b"0"))
        if time.time() >= until:
            return  # retention lapsed
        if mode == b"GOVERNANCE" and bypass_governance and authenticated:
            return  # the sanctioned escape hatch; COMPLIANCE has none
        raise S3Error(
            403, "AccessDenied", f"object locked until {_iso(until)}"
        )

    # ---- object tagging --------------------------------------------------
    def get_tagging(self, bucket: str, key: str) -> bytes:
        entry = self.get_object_entry(bucket, key)
        root = ET.Element("Tagging", xmlns=XMLNS)
        tagset = _el(root, "TagSet")
        blob = entry.extended.get("tagging")
        if blob:
            for pair in blob.decode().split("&"):
                if not pair:
                    continue
                k, _, v = pair.partition("=")
                t = _el(tagset, "Tag")
                _el(t, "Key", urllib.parse.unquote(k))
                _el(t, "Value", urllib.parse.unquote(v))
        return _xml(root)

    @staticmethod
    def encode_tags(pairs: list[tuple[str, str]]) -> bytes:
        """Validate + encode (key, value) tags into the stored wire form;
        ONE path for the XML body and the x-amz-tagging header."""
        if len(pairs) > 10:
            raise S3Error(400, "BadRequest", "at most 10 tags per object")
        out = []
        for k, v in pairs:
            if not k:
                raise S3Error(400, "InvalidTag", "empty tag key")
            out.append(
                f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            )
        return "&".join(out).encode()

    @classmethod
    def parse_tag_header(cls, header: str) -> bytes:
        """x-amz-tagging: url-encoded k=v&k=v — same validation as XML."""
        pairs = urllib.parse.parse_qsl(header, keep_blank_values=True)
        if not pairs and header.strip():
            raise S3Error(400, "InvalidTag", f"bad x-amz-tagging {header!r}")
        return cls.encode_tags(pairs)

    def put_tagging(self, bucket: str, key: str, body: bytes) -> None:
        entry = self.get_object_entry(bucket, key)
        try:
            req = ET.fromstring(body.decode())
        except (ET.ParseError, UnicodeDecodeError) as e:
            raise S3Error(400, "MalformedXML", str(e))
        ns = {"s3": XMLNS} if req.tag.startswith("{") else {}
        tag_els = (
            req.findall(".//s3:Tag", namespaces=ns) if ns else req.findall(".//Tag")
        )
        pairs = [
            (
                (t.findtext("s3:Key", namespaces=ns) if ns else t.findtext("Key")) or "",
                (t.findtext("s3:Value", namespaces=ns) if ns else t.findtext("Value")) or "",
            )
            for t in tag_els
        ]
        entry.extended["tagging"] = self.encode_tags(pairs)
        self.filer.update_entry(entry)

    def delete_tagging(self, bucket: str, key: str) -> None:
        entry = self.get_object_entry(bucket, key)
        entry.extended.pop("tagging", None)
        self.filer.update_entry(entry)

    # ---- bucket lifecycle (expiration rules) -----------------------------
    # (reference s3api lifecycle handlers + the filer's TTL sweep: rules
    # with a Days-based Expiration per prefix; applied by a periodic
    # pass, the way the reference's filer applies bucket TTLs)
    def put_lifecycle(self, bucket: str, body: bytes) -> None:
        rules = _parse_lifecycle_xml(body)  # validates
        if not rules:
            raise S3Error(400, "MalformedXML", "no lifecycle rules")
        self.set_bucket_config(bucket, "lifecycle", body)

    def get_lifecycle_xml(self, bucket: str) -> bytes:
        blob = self.bucket_config(bucket, "lifecycle")
        if not blob:
            raise S3Error(
                404, "NoSuchLifecycleConfiguration", "no lifecycle on bucket"
            )
        return bytes(blob)

    def delete_lifecycle(self, bucket: str) -> None:
        self.set_bucket_config(bucket, "lifecycle", None)

    def apply_lifecycle(self, bucket: str | None = None) -> int:
        """Expire objects per each bucket's rules; returns deletions.
        Run from the gateway's sweep thread or an ops hook/test."""
        deleted = 0
        buckets = (
            [bucket]
            if bucket
            else [
                e.name
                for e in self.filer.list_entries(BUCKETS_ROOT, limit=10_000)
                if e.is_directory and not e.name.startswith(".")
            ]
        )
        now = time.time()
        for b in buckets:
            blob = self.bucket_config(b, "lifecycle")
            if not blob:
                continue
            rules = [
                # weedlint: disable=W005 — compared to object wall-clock mtimes
                (prefix, now - days * 86400)
                for prefix, days, enabled in _parse_lifecycle_xml(bytes(blob))
                if enabled
            ]
            if not rules:
                continue
            # ONE walk per bucket, every rule tested per key (N walks for
            # N rules would rescan large buckets repeatedly)
            doomed: list[tuple[str, float]] = []
            for key, e in self.walk_keys(b, ""):
                for prefix, cutoff in rules:
                    if (
                        key.startswith(prefix)
                        and e.attr.crtime
                        and e.attr.crtime < cutoff
                    ):
                        doomed.append((key, cutoff))
                        break
            for key, cutoff in doomed:
                # re-check at delete time: an overwrite since the scan
                # resets crtime and must not lose the fresh object
                live = self.filer.find_entry(self.object_path(b, key))
                if (
                    live is None
                    or not live.attr.crtime
                    or live.attr.crtime >= cutoff
                ):
                    continue
                try:
                    self.delete_object(b, key)
                    deleted += 1
                except S3Error:
                    pass  # locked/held objects survive their rules
        return deleted

    # ---- ACLs ------------------------------------------------------------
    # Canned ACLs (private / public-read / public-read-write) are the
    # compact form; explicit AccessControlPolicy grant bodies and
    # x-amz-grant-* headers (s3/acl.py) replace them when supplied —
    # reference s3api_object_handlers_acl.go + s3api_acl_helper.go.
    CANNED_ACLS = ("private", "public-read", "public-read-write")
    OWNER_ID = "weedtpu"

    @classmethod
    def validate_canned_acl(cls, canned: str) -> str:
        if canned not in cls.CANNED_ACLS:
            raise S3Error(400, "InvalidArgument", f"unsupported ACL {canned!r}")
        return canned

    def put_bucket_acl(self, bucket: str, canned: str) -> None:
        self.validate_canned_acl(canned)
        # a canned ACL REPLACES any explicit grants, and vice versa
        self.set_bucket_config(bucket, "acl_grants", None)
        self.set_bucket_config(
            bucket, "acl", None if canned == "private" else canned.encode()
        )

    def put_bucket_acl_grants(self, bucket: str, grants) -> None:
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        self.set_bucket_config(bucket, "acl", None)
        self.set_bucket_config(
            bucket, "acl_grants", acl_mod.grants_to_json(grants)
        )

    def get_bucket_acl_xml(self, bucket: str) -> bytes:
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        grants = acl_mod.grants_from_json(
            self.bucket_config(bucket, "acl_grants")
        )
        if grants is not None:
            return acl_mod.grants_xml(self.OWNER_ID, grants)
        canned = (self.bucket_config(bucket, "acl") or b"private").decode()
        return self.canned_acl_xml(canned)

    def get_object_acl_xml(self, bucket: str, key: str) -> bytes:
        """The object's own ACL (grants or canned) when set, else the
        bucket's (reference object-level ACLs,
        s3api_object_handlers_acl.go)."""
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        entry = self.get_object_entry(bucket, key)  # 404 on missing
        grants = acl_mod.grants_from_json(entry.extended.get("acl_grants"))
        if grants is not None:
            return acl_mod.grants_xml(self.OWNER_ID, grants)
        canned = entry.extended.get("acl")
        if canned:
            return self.canned_acl_xml(canned.decode())
        return self.get_bucket_acl_xml(bucket)

    def put_object_acl(self, bucket: str, key: str, canned: str) -> None:
        self.validate_canned_acl(canned)
        entry = self.get_object_entry(bucket, key)
        entry.extended.pop("acl_grants", None)
        if canned == "private":
            entry.extended.pop("acl", None)
        else:
            entry.extended["acl"] = canned.encode()
        self.filer.update_entry(entry)

    def put_object_acl_grants(self, bucket: str, key: str, grants) -> None:
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        entry = self.get_object_entry(bucket, key)
        entry.extended.pop("acl", None)
        entry.extended["acl_grants"] = acl_mod.grants_to_json(grants)
        self.filer.update_entry(entry)

    def canned_acl_xml(self, canned: str) -> bytes:
        root = ET.Element("AccessControlPolicy", xmlns=XMLNS)
        root.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
        owner = _el(root, "Owner")
        _el(owner, "ID", "weedtpu")
        grants = _el(root, "AccessControlList")
        g = _el(grants, "Grant")
        ge = _el(g, "Grantee")
        ge.set("xsi:type", "CanonicalUser")
        _el(ge, "ID", "weedtpu")
        _el(g, "Permission", "FULL_CONTROL")
        if canned != "private":
            g2 = _el(grants, "Grant")
            ge2 = _el(g2, "Grantee")
            ge2.set("xsi:type", "Group")
            _el(ge2, "URI", "http://acs.amazonaws.com/groups/global/AllUsers")
            _el(g2, "Permission", "READ")
            if canned == "public-read-write":
                g3 = _el(grants, "Grant")
                ge3 = _el(g3, "Grantee")
                ge3.set("xsi:type", "Group")
                _el(ge3, "URI", "http://acs.amazonaws.com/groups/global/AllUsers")
                _el(g3, "Permission", "WRITE")
        return _xml(root)

    @staticmethod
    def acl_allows_anonymous(canned: bytes | None, action: str) -> bool:
        if not canned:
            return False
        reads = ("s3:GetObject", "s3:ListBucket", "s3:GetBucketLocation")
        writes = ("s3:PutObject", "s3:DeleteObject")
        if canned == b"public-read":
            return action in reads
        if canned == b"public-read-write":
            return action in reads + writes
        return False

    def cors_response_headers(
        self, bucket: str, origin: str | None, method: str, request_headers: str = ""
    ) -> dict[str, str] | None:
        if not origin or not bucket:
            return None
        rules = self.cors_rules(bucket)
        if not rules:
            return None
        from seaweedfs_tpu_torch.s3 import cors as cors_mod

        return cors_mod.response_headers(rules, origin, method, request_headers)


def _parse_policy_blob(blob: bytes | None) -> dict | None:
    """Structural parse only — NOT the strict PUT-time validation.

    A stored document may predate the current validator (e.g. a policy
    with a Condition block stored before conditions were supported);
    re-validating at read time and returning None would silently drop
    the whole document, including its Deny statements — fail-open.  The
    evaluator handles unevaluatable legacy statements fail-closed
    instead (policy.evaluate: a Deny with a condition it cannot judge
    fires; an Allow never matches)."""
    if not blob:
        return None
    import json as _json

    try:
        doc = _json.loads(blob)
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(doc, dict) and isinstance(doc.get("Statement"), list):
        return doc
    return None


def _parse_cors_blob(blob: bytes | None):
    if not blob:
        return None
    from seaweedfs_tpu_torch.s3 import cors as cors_mod

    try:
        return cors_mod.parse_cors(blob)
    except cors_mod.CorsError:
        return None


def _parse_retention_xml(body: bytes) -> tuple[str, int]:
    """Retention XML -> (mode, retain_until_unix)."""
    import calendar as _cal

    try:
        req = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e))
    ns = {"s3": XMLNS} if req.tag.startswith("{") else {}

    def find(tag):
        return (
            req.findtext(f"s3:{tag}", namespaces=ns) if ns else req.findtext(tag)
        ) or ""

    mode = find("Mode").upper()
    if mode not in ("GOVERNANCE", "COMPLIANCE"):
        raise S3Error(400, "MalformedXML", f"bad retention Mode {mode!r}")
    raw = find("RetainUntilDate")
    try:
        until = int(
            _cal.timegm(time.strptime(raw[:19], "%Y-%m-%dT%H:%M:%S"))
        )
    except (ValueError, IndexError) as e:
        raise S3Error(400, "MalformedXML", f"bad RetainUntilDate {raw!r}") from e
    if until <= time.time():
        raise S3Error(400, "InvalidRequest", "RetainUntilDate must be future")
    return mode, until


def _parse_lifecycle_xml(body: bytes) -> list[tuple[str, int, bool]]:
    """LifecycleConfiguration -> [(prefix, days, enabled)]; only the
    Days-based Expiration action is modeled."""
    try:
        req = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e))
    ns = {"s3": XMLNS} if req.tag.startswith("{") else {}

    def findall(el, tag):
        return el.findall(f"s3:{tag}", namespaces=ns) if ns else el.findall(tag)

    def findtext(el, path):
        if ns:
            return el.findtext(
                "/".join(f"s3:{p}" for p in path.split("/")), namespaces=ns
            )
        return el.findtext(path)

    rules = []
    for rule in findall(req, "Rule"):
        days_raw = findtext(rule, "Expiration/Days")
        if not days_raw:
            raise S3Error(400, "MalformedXML", "Rule needs Expiration/Days")
        try:
            days = int(days_raw)
        except ValueError as e:
            raise S3Error(400, "MalformedXML", f"bad Days {days_raw!r}") from e
        if days < 1:
            raise S3Error(400, "InvalidArgument", "Days must be >= 1")
        prefix = (
            findtext(rule, "Filter/Prefix") or findtext(rule, "Prefix") or ""
        )
        status = (findtext(rule, "Status") or "").strip()
        if status not in ("Enabled", "Disabled"):
            # a typo'd Status must fail at PUT time, not silently never
            # fire (or worse, silently fire when omitted)
            raise S3Error(400, "MalformedXML", f"bad Rule Status {status!r}")
        rules.append((prefix, days, status == "Enabled"))
    return rules


def _parse_status_xml(
    body: bytes, root_tag: str, accepted: tuple[str, ...] = ("ON", "OFF")
) -> str:
    """<X><Status>v</Status></X> -> the canonical accepted value."""
    try:
        req = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e))
    ns = {"s3": XMLNS} if req.tag.startswith("{") else {}
    status = (
        (req.findtext("s3:Status", namespaces=ns) if ns else req.findtext("Status"))
        or ""
    )
    for want in accepted:
        if status.upper() == want.upper():
            return want
    raise S3Error(400, "MalformedXML", f"bad Status {status!r}")


def _parse_bucket_tagging_xml(body: bytes) -> list[tuple[str, str]]:
    """Validate a <Tagging><TagSet><Tag>... document (reference
    s3api_bucket_handlers.go PutBucketTagging); returns the pairs."""
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e))
    ns = {"s3": XMLNS} if root.tag.startswith("{") else {}
    tags = (
        root.findall(".//s3:Tag", namespaces=ns)
        if ns
        else root.findall(".//Tag")
    )
    pairs = []
    for t in tags:
        k = (t.findtext("s3:Key", namespaces=ns) if ns else t.findtext("Key")) or ""
        v = (t.findtext("s3:Value", namespaces=ns) if ns else t.findtext("Value")) or ""
        if not k or len(k) > 128 or len(v) > 256:
            raise S3Error(400, "InvalidTag", k)
        pairs.append((k, v))
    if len(pairs) != len({k for k, _ in pairs}):
        raise S3Error(400, "InvalidTag", "duplicate keys")
    return pairs


def _parse_website_xml(body: bytes) -> None:
    """Validate a WebsiteConfiguration document (IndexDocument/Suffix
    required unless RedirectAllRequestsTo; reference
    s3api_bucket_handlers.go PutBucketWebsite stores the raw config the
    same way)."""
    try:
        root = ET.fromstring(body.decode())
    except (ET.ParseError, UnicodeDecodeError) as e:
        raise S3Error(400, "MalformedXML", str(e))
    ns = {"s3": XMLNS} if root.tag.startswith("{") else {}

    def find(p):
        return (
            root.find(f"s3:{p}", namespaces=ns) if ns else root.find(p)
        )

    if find("RedirectAllRequestsTo") is None:
        idx = find("IndexDocument")
        suffix = None
        if idx is not None:
            suffix = (
                idx.findtext("s3:Suffix", namespaces=ns)
                if ns
                else idx.findtext("Suffix")
            )
        if not suffix:
            raise S3Error(
                400, "MalformedXML",
                "WebsiteConfiguration needs IndexDocument/Suffix or "
                "RedirectAllRequestsTo",
            )


def _charged_read_bytes(size: int, range_header: str) -> int:
    """Bytes a GET will actually move — computed by the SAME parser the
    read path serves with (util.http_range), so admission can never
    under-charge a request the handler answers in full (e.g. a reversed
    range falls back to a 200 with the whole body)."""
    from seaweedfs_tpu_torch.util.http_range import RangeNotSatisfiable, parse_range

    try:
        rng = parse_range(range_header or None, size)
    except RangeNotSatisfiable:
        return 0  # 416: no body moves
    if rng is None:
        return size  # absent / invalid / multi-range → full body
    lo, hi = rng
    return hi - lo + 1


def _request_action(method: str, q, bucket: str, key: str) -> tuple[str, str]:
    """Map the request onto an (IAM action, resource ARN) pair for the
    bucket-policy engine (reference policy_engine/statement.go action
    constants)."""
    from seaweedfs_tpu_torch.s3 import policy as policy_mod

    if not bucket:
        return "s3:ListAllMyBuckets", "*"
    arn_bkt = policy_mod.resource_arn(bucket)
    arn_obj = policy_mod.resource_arn(bucket, key)
    if method in ("GET", "HEAD"):
        if not key:
            for sub, action in (
                ("policy", "s3:GetBucketPolicy"),
                ("cors", "s3:GetBucketCORS"),
                ("versioning", "s3:GetBucketVersioning"),
                ("versions", "s3:ListBucketVersions"),
                ("location", "s3:GetBucketLocation"),
                ("uploads", "s3:ListBucketMultipartUploads"),
                ("acl", "s3:GetBucketAcl"),
                ("lifecycle", "s3:GetLifecycleConfiguration"),
            ):
                if sub in q:
                    return action, arn_bkt
            return "s3:ListBucket", arn_bkt
        if "uploadId" in q:
            return "s3:ListMultipartUploadParts", arn_obj
        if "acl" in q:
            return "s3:GetObjectAcl", arn_obj
        if "tagging" in q:
            return "s3:GetObjectTagging", arn_obj
        if "retention" in q:
            return "s3:GetObjectRetention", arn_obj
        if "legal-hold" in q:
            return "s3:GetObjectLegalHold", arn_obj
        return (
            "s3:GetObjectVersion" if "versionId" in q else "s3:GetObject"
        ), arn_obj
    if method == "PUT":
        if not key:
            for sub, action in (
                ("policy", "s3:PutBucketPolicy"),
                ("cors", "s3:PutBucketCORS"),
                ("versioning", "s3:PutBucketVersioning"),
                ("acl", "s3:PutBucketAcl"),
                ("lifecycle", "s3:PutLifecycleConfiguration"),
            ):
                if sub in q:
                    return action, arn_bkt
            return "s3:CreateBucket", arn_bkt
        if "acl" in q:
            return "s3:PutObjectAcl", arn_obj
        if "tagging" in q:
            return "s3:PutObjectTagging", arn_obj
        if "retention" in q:
            return "s3:PutObjectRetention", arn_obj
        if "legal-hold" in q:
            return "s3:PutObjectLegalHold", arn_obj
        return "s3:PutObject", arn_obj
    if method == "POST":
        if key:
            if "select" in q:
                # SelectObjectContent READS the object — authorizing it
                # as a write would let a write-only policy exfiltrate
                return "s3:GetObject", arn_obj
            return "s3:PutObject", arn_obj
        if "delete" in q:
            return "s3:DeleteObject", arn_bkt + "/*"
        return "s3:PutObject", arn_bkt
    if method == "DELETE":
        if not key:
            for sub, action in (
                ("policy", "s3:DeleteBucketPolicy"),
                ("cors", "s3:PutBucketCORS"),
                ("lifecycle", "s3:PutLifecycleConfiguration"),
            ):
                if sub in q:
                    return action, arn_bkt
            return "s3:DeleteBucket", arn_bkt
        if "uploadId" in q:
            return "s3:AbortMultipartUpload", arn_obj
        if "tagging" in q:
            return "s3:DeleteObjectTagging", arn_obj
        return (
            "s3:DeleteObjectVersion" if "versionId" in q else "s3:DeleteObject"
        ), arn_obj
    return "s3:*", arn_bkt


class _S3HttpHandler(QuietHandler):
    s3: S3ApiServer = None

    def _send_xml(self, body: bytes, status: int = 200, headers=None):
        self._reply(status, body, "application/xml", headers=headers)

    def _error(self, err: S3Error):
        root = ET.Element("Error")
        _el(root, "Code", err.code)
        _el(root, "Message", str(err))
        self._send_xml(_xml(root), err.status)

    def _route(self):
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query, keep_blank_values=True)
        parts = urllib.parse.unquote(url.path).lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        return url, q, bucket, key

    def _policy_context(self, who: str, q=None) -> dict[str, list[str]]:
        """Condition-key map for the bucket-policy engine: the request
        facts AWS global/s3 condition keys expose (reference
        policy_engine/integration.go builds the same map from the
        request).  Keys are lower-cased; values are lists."""
        import datetime as _dt
        import ssl as _ssl

        now = time.time()
        ctx: dict[str, list[str]] = {
            "aws:sourceip": [self.client_address[0]],
            "aws:securetransport": [
                "true"
                if isinstance(self.connection, _ssl.SSLSocket)
                else "false"
            ],
            "aws:currenttime": [
                _dt.datetime.fromtimestamp(now, _dt.timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%SZ"
                )
            ],
            "aws:epochtime": [str(int(now))],
        }
        if who != "*":
            ctx["aws:username"] = [who]
        for hdr, ckey in (
            ("User-Agent", "aws:useragent"),
            ("Referer", "aws:referer"),
        ):
            v = self.headers.get(hdr)
            if v:
                ctx[ckey] = [v]
        for hdr in (
            "x-amz-acl",
            "x-amz-server-side-encryption",
            "x-amz-storage-class",
            "x-amz-copy-source",
            "x-amz-metadata-directive",
            "x-amz-content-sha256",
        ):
            v = self.headers.get(hdr)
            if v:
                ctx["s3:" + hdr] = [v]
        if q is None:
            q = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query,
                keep_blank_values=True,
            )
        for qk, ckey in (
            ("prefix", "s3:prefix"),
            ("delimiter", "s3:delimiter"),
            ("max-keys", "s3:max-keys"),
            ("versionId", "s3:versionid"),
        ):
            if qk in q and q[qk]:
                ctx[ckey] = [q[qk][0]]
        return ctx

    def _read_body(self) -> bytes:
        """Raw wire bytes — what the payload hash in the Authorization
        flow covers.  aws-chunked framing is decoded *after* auth, under
        the verified signature context (see _auth_and_decode)."""
        length = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(length) if length else b""

    def _auth_and_decode(self, raw_body):
        """Verify the Authorization header (or presigned query), then
        decode (and, with identities configured, chunk-signature-verify)
        streaming bodies.  Returns (body, identity-or-None)."""
        if isinstance(raw_body, StreamingBody):
            # minted only by _streaming_put_body (open-access plain object
            # PUT): no signature to verify, no framing to strip — the body
            # flows straight off the socket into the chunk uploader
            return raw_body, None
        url = urllib.parse.urlparse(self.path)
        open_access = self.s3.verifier.open_access
        if "X-Amz-Signature=" in (url.query or ""):
            ident = self.s3.verifier.verify_presigned(
                self.command, url.path, url.query, self.headers
            )
            return raw_body, ident  # presigned payloads are UNSIGNED-PAYLOAD
        if not open_access:
            # legacy Signature V2 (reference auth_signature_v2.go): header
            # form `AWS access:sig` and the AWSAccessKeyId presigned form
            from seaweedfs_tpu_torch.s3 import sigv2

            if sigv2.is_v2_header(self.headers) or sigv2.is_v2_presigned(
                url.query or ""
            ):
                if sigv2.is_v2_header(self.headers):
                    ident = sigv2.verify_v2_header(
                        self.s3.verifier.identities,
                        self.command, url.path, url.query, self.headers,
                    )
                else:
                    ident = sigv2.verify_v2_presigned(
                        self.s3.verifier.identities,
                        self.command, url.path, url.query, self.headers,
                    )
                # v2's only payload binding is Content-MD5: when the
                # client signed one, hold the body to it (the v4 branch
                # binds x-amz-content-sha256 the same way)
                md5_hdr = self.headers.get("Content-MD5", "")
                if md5_hdr:
                    import base64 as _b64

                    actual = _b64.b64encode(
                        hashlib.md5(raw_body).digest()
                    ).decode()
                    if actual != md5_hdr.strip():
                        raise AccessDenied(
                            "Content-MD5 does not match payload"
                        )
                return raw_body, ident
        claimed = self.headers.get("x-amz-content-sha256")
        streaming = (claimed or "").startswith("STREAMING-")
        if claimed is None:
            claimed = hashlib.sha256(raw_body).hexdigest()
        elif claimed != "UNSIGNED-PAYLOAD" and not streaming:
            # the signature only covers the *claimed* hash — bind it to the
            # bytes actually received (reference auth does the same check)
            actual = hashlib.sha256(raw_body).hexdigest()
            if not open_access and claimed != actual:
                raise AccessDenied("x-amz-content-sha256 does not match payload")
        ctx = self.s3.verifier.verify_context(
            self.command, url.path, url.query, self.headers, claimed
        )
        identity = ctx.identity if ctx else None
        if not streaming:
            return raw_body, identity
        if not open_access and claimed != STREAMING_PAYLOAD:
            # unsigned/trailer streaming variants carry no verifiable chain
            raise AccessDenied(f"unsupported streaming payload type {claimed}")
        decoded_length = None
        if self.headers.get("x-amz-decoded-content-length"):
            decoded_length = int(self.headers["x-amz-decoded-content-length"])
        elif not open_access:
            raise AccessDenied("streaming upload missing x-amz-decoded-content-length")
        return decode_aws_chunked(raw_body, ctx, decoded_length), identity

    def _reject_mixed_acl_forms(self) -> None:
        """x-amz-acl together with x-amz-grant-*: AWS rejects the
        combination — silently applying one and dropping the other would
        diverge from what the caller believes was set."""
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        if acl_mod.has_grant_headers(self.headers):
            raise S3Error(
                400, "InvalidRequest",
                "cannot mix x-amz-acl with x-amz-grant-* headers",
            )

    def _acl_grants_from_request(self, body: bytes):
        """Explicit grants from x-amz-grant-* headers or an
        AccessControlPolicy body (header form wins, reference
        ExtractAcl precedence); AclError maps to 400."""
        from seaweedfs_tpu_torch.s3 import acl as acl_mod

        try:
            grants = acl_mod.parse_grant_headers(
                self.headers, S3ApiServer.OWNER_ID
            )
            if grants:
                return grants
            if not body.strip():
                raise acl_mod.AclError(
                    "MissingSecurityHeader",
                    "no ACL supplied (x-amz-acl, x-amz-grant-*, or body)",
                )
            return acl_mod.parse_acl_xml(body, S3ApiServer.OWNER_ID)
        except acl_mod.AclError as e:
            raise S3Error(400, e.code, str(e)) from e

    def _authorize_copy_source(self, source: str) -> None:
        """The destination action alone must not authorize READING the
        copy source — evaluate s3:GetObject against the source bucket's
        policy for this caller (anonymous callers need an explicit
        Allow there, exactly as a direct GET would)."""
        from seaweedfs_tpu_torch.s3 import policy as policy_mod

        src = urllib.parse.unquote(source.lstrip("/"))
        src_bucket, _, src_key = src.partition("/")
        doc = self.s3.bucket_policy_doc(src_bucket)
        who = getattr(self, "_principal", "*")
        decision = policy_mod.evaluate(
            doc,
            "s3:GetObject",
            policy_mod.resource_arn(src_bucket, src_key),
            who,
            self._policy_context(who) if doc else None,
        )
        if decision == policy_mod.DENY:
            raise AccessDenied("explicit deny on the copy source")
        if (
            who == "*"
            and not self.s3.verifier.open_access
            and decision != policy_mod.ALLOW
        ):
            raise AccessDenied("copy source requires authorization")

    def _meta_headers(self) -> dict[str, bytes]:
        return {
            k.lower(): v.encode()
            for k, v in self.headers.items()
            if k.lower().startswith("x-amz-meta-")
        }

    def _dispatch(self, raw: bytes = b""):
        """Instrumentation shell around the request: edge trace span
        (roots a new trace unless the client sent a traceparent),
        per-action counter + latency histogram + op-class sketch, and the
        access log.  The actual S3 semantics live in _dispatch_inner."""
        t0 = time.perf_counter()
        _url, q, bucket, key = self._route()
        action, arn = _request_action(self.command, q, bucket, key)
        op = action.split(":", 1)[-1]
        # record the response status for metrics/access log: every reply
        # (including CORS-wrapped ones) funnels through this bound wrapper
        self._last_status = 0
        self._resp_bytes = 0
        base_reply = QuietHandler._reply.__get__(self)

        def recording_reply(
            code, body=b"", ctype="application/octet-stream", headers=None,
            length=None,
        ):
            self._last_status = code
            self._resp_bytes = len(body) if length is None else length
            base_reply(code, body, ctype, headers=headers, length=length)

        self._reply = recording_reply
        with trace.span(op, service="s3", headers=self.headers,
                        attrs={"bucket": bucket, "key": key} if bucket else None) as sp:
            try:
                self._dispatch_inner(raw, q, bucket, key, action, arn)
            finally:
                dur = time.perf_counter() - t0
                code = self._last_status or 0
                stats.S3_REQUESTS.inc(action=op, code=str(code))
                stats.S3_REQUEST_SECONDS.observe(dur, action=op)
                # the mergeable tail-latency sketch, keyed by op class (small
                # and large GETs split on response size): what the SLO engine
                # and the cluster aggregator evaluate
                sketch.record(sketch.s3_op_class(op, self._resp_bytes), dur)
                log = self.s3.access_log
                if log is not None:
                    log.log(
                        client=self.client_address[0],
                        method=self.command,
                        path=self.path,
                        action=op,
                        status=code,
                        nbytes=len(raw) if raw else self._resp_bytes,
                        dur_ms=dur * 1e3,
                        trace_id=sp.trace_id,
                    )

    def _claimed_access_key(self) -> str:
        """The access key the request CLAIMS, parsed cheaply (v4 header,
        v4 presigned query, or v2 forms) — the QoS tenant key.  This is
        pre-verification on purpose: admission control must shed load
        before paying signature work, and a forged key only buys the
        forger that tenant's (tighter) limit, never broader access —
        authentication still runs on every admitted request."""
        auth = self.headers.get("Authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256"):
            for part in auth.split(","):
                part = part.strip()
                if "Credential=" in part:
                    cred = part.split("Credential=", 1)[1]
                    return cred.split("/", 1)[0]
        elif auth.startswith("AWS "):
            return auth[4:].split(":", 1)[0]
        query = urllib.parse.urlparse(self.path).query or ""
        if "X-Amz-Credential=" in query:
            q = urllib.parse.parse_qs(query)
            cred = (q.get("X-Amz-Credential") or [""])[0]
            return cred.split("/", 1)[0]
        if "AWSAccessKeyId=" in query:
            q = urllib.parse.parse_qs(query)
            return (q.get("AWSAccessKeyId") or [""])[0]
        return "anonymous"

    def _shed(self, status: int, code: str, message: str, retry_after: float) -> None:
        """One shed response: 429 (QoS) / 503 (breaker, dead shard) with
        Retry-After so well-behaved clients back off instead of
        hammering the very plane that is shedding."""
        root = ET.Element("Error")
        _el(root, "Code", code)
        _el(root, "Message", message)
        headers = {}
        if retry_after > 0:
            import math

            headers["Retry-After"] = str(max(1, math.ceil(retry_after)))
        self._send_xml(_xml(root), status, headers=headers or None)

    def _dispatch_inner(self, raw, q, bucket, key, action, arn):
        from seaweedfs_tpu_torch.s3 import cors as cors_mod
        from seaweedfs_tpu_torch.s3 import policy as policy_mod

        from seaweedfs_tpu_torch.s3.circuit_breaker import TooManyRequests

        orig_reply = self._reply
        is_write = self.command in ("PUT", "POST", "DELETE")
        nbytes = len(raw)
        # tenant/bucket QoS admission first: rate sheds cost a header
        # parse and a token-bucket probe — no signature, no filer I/O
        if self.s3.qos.enabled:
            adm = self.s3.qos.admit(
                self._claimed_access_key(),
                bucket,
                write_bytes=(nbytes if self.command in ("PUT", "POST") and key else -1),
                usage=lambda: self.s3.bucket_usage(bucket),
            )
            if not adm.ok:
                if adm.limit.startswith("quota_"):
                    # waiting won't free quota: a hard 403, like the
                    # quota_readonly freeze below
                    self._error(S3Error(
                        403, "QuotaExceeded",
                        f"bucket {bucket} is over its configured "
                        f"{adm.limit} quota",
                    ))
                else:
                    self._shed(
                        429, "SlowDown",
                        f"{adm.scope} request rate limit reached",
                        adm.retry_after,
                    )
                return
        # subresource reads move no object body; anything else with a key
        # (including presigned URLs, whose auth rides the query string)
        # is a download and must count its size
        _NO_BODY_SUBRESOURCES = (
            "tagging", "acl", "retention", "legal-hold", "uploadId",
            "versioning", "policy", "cors", "attributes",
        )
        if (
            self.command == "GET"
            and bucket
            and key
            and not any(s in q for s in _NO_BODY_SUBRESOURCES)
            and self.s3.circuit_breaker.wants_read_bytes(bucket)
        ):
            # downloads count their object's size against readBytes (the
            # request body is empty; the response is the load) — but a
            # Range request only moves the requested slice, so charge
            # that, not the whole object (a ranged reader of a huge
            # object must not drain the bucket's readBytes budget).
            # SSE objects are the exception: the GCM path materializes
            # and decrypts the WHOLE object before slicing, so a ranged
            # read of an encrypted object costs the backend full size.
            from seaweedfs_tpu_torch.s3 import sse as sse_mod

            try:
                obj = self.s3.find_entry_cached(self.s3.object_path(bucket, key))
                if obj is not None:
                    if sse_mod.is_encrypted(obj.extended):
                        nbytes = obj.size
                    else:
                        nbytes = _charged_read_bytes(
                            obj.size, self.headers.get("Range", "")
                        )
            except Exception as e:  # noqa: BLE001 — lookup blip: count-only
                if wlog.V(2):
                    wlog.info("s3: charged-bytes lookup failed, counting request only: %s", e)
        try:
            release = self.s3.circuit_breaker.acquire(bucket, is_write, nbytes)
        except TooManyRequests as e:
            # e.key is one of the four _LIMIT_KEYS (bounded enum); the
            # label is named for what it is — the limit that tripped
            stats.S3_THROTTLED.inc(scope=e.scope, limit=e.key, bucket=e.bucket)
            self._error(S3Error(503, "SlowDown", str(e)))
            return
        try:
            # one bucket-entry fetch serves CORS headers and the policy
            # check; the op handlers still do their own require_bucket
            bentry = None
            if bucket:
                be = self.s3.find_entry_cached(self.s3.bucket_path(bucket))
                if be is not None and be.is_directory:
                    bentry = be
            cors_extra = None
            origin = self.headers.get("Origin")
            if bentry is not None and origin:
                rules = _parse_cors_blob(bentry.extended.get("cors"))
                if rules:
                    cors_extra = cors_mod.response_headers(
                        rules, origin, self.command
                    )
            if cors_extra:

                def reply_cors(code, body=b"", ctype="application/octet-stream", headers=None, length=None):
                    orig_reply(code, body, ctype, {**cors_extra, **(headers or {})}, length)

                self._reply = reply_cors
                # the native splice writes its own response head: it
                # takes the granted CORS headers from here
                self._splice_headers = cors_extra

            # authentication, then bucket-policy authorization: an explicit
            # Deny beats any identity; a policy Allow admits anonymous
            # callers a failed/missing signature would otherwise reject
            # (action/arn were mapped once in _dispatch)
            identity = None
            auth_err: AccessDenied | None = None
            body = raw
            try:
                body, identity = self._auth_and_decode(raw)
            except AccessDenied as e:
                auth_err = e
            doc = (
                _parse_policy_blob(bentry.extended.get("policy"))
                if bentry is not None
                else None
            )
            who = identity.access_key if identity else "*"
            self._principal = who  # copy-source auth needs the caller
            decision = policy_mod.evaluate(
                doc, action, arn, who,
                self._policy_context(who, q) if doc else None,
            )
            if decision == policy_mod.DENY:
                raise AccessDenied("explicit deny by bucket policy")
            if auth_err is not None:
                from seaweedfs_tpu_torch.s3 import acl as acl_mod

                acl_ok = bentry is not None and (
                    S3ApiServer.acl_allows_anonymous(
                        bentry.extended.get("acl"), action
                    )
                    or acl_mod.grants_allow(
                        acl_mod.grants_from_json(
                            bentry.extended.get("acl_grants")
                        ),
                        action,
                        None,  # anonymous caller
                    )
                )
                if (
                    not acl_ok
                    and key
                    and action in ("s3:GetObject", "s3:GetObjectVersion")
                ):
                    # object-level ACL (public-read / AllUsers grant on
                    # one object inside a private bucket) — reference
                    # object ACLs
                    try:
                        oe = self.s3.find_entry_cached(
                            self.s3.object_path(bucket, key)
                        )
                    except Exception as e:  # noqa: BLE001 — lookup blip
                        if wlog.V(2):
                            wlog.info("s3: object-ACL lookup failed: %s", e)
                        oe = None
                    acl_ok = oe is not None and (
                        S3ApiServer.acl_allows_anonymous(
                            oe.extended.get("acl"), action
                        )
                        or acl_mod.grants_allow(
                            acl_mod.grants_from_json(
                                oe.extended.get("acl_grants")
                            ),
                            action,
                            None,
                        )
                    )
                # browser form POSTs authenticate via the signed policy
                # document INSIDE the body, not headers — the handler
                # verifies it (reference postpolicy auth flow).  `not q`
                # is load-bearing: POST /bucket?delete with a multipart
                # Content-Type must NOT ride this bypass into _multi_delete
                form_post = (
                    self.command == "POST"
                    and bucket
                    and not key
                    and not q
                    and self._is_form_post()
                )
                if decision != policy_mod.ALLOW and not acl_ok and not form_post:
                    raise auth_err
                # anonymous-but-policy-allowed: plain bodies only
                if (self.headers.get("x-amz-content-sha256") or "").startswith(
                    "STREAMING-"
                ):
                    body = decode_aws_chunked(raw)
            if (
                is_write
                and key
                and bentry is not None
                and bentry.extended.get("quota_readonly")
                and self.command in ("PUT", "POST")
            ):
                # bucket frozen by s3.bucket.quota.check (reference
                # s3_bucket_quota enforcement marks the bucket read-only)
                raise S3Error(
                    403, "QuotaExceeded",
                    f"bucket {bucket} is over its configured quota",
                )
            handler = getattr(self, f"_do_{self.command.lower()}")
            handler(q, bucket, key, body)
        except AccessDenied as e:
            self._error(S3Error(403, "AccessDenied", str(e)))
        except S3Error as e:
            self._error(e)
        except ShardUnavailable as e:
            # a dead filer shard: bounded-latency shedding (the breaker
            # opened or the deadline fired), never a wedged gateway — and
            # a write that lands here was never acked, so clients retry
            # against the recovered shard with zero acked-write loss
            self._shed(503, "SlowDown", str(e), e.retry_after)
        except FilerError as e:
            self._error(S3Error(409, "InvalidRequest", str(e)))
        except (ValueError, ET.ParseError) as e:
            self._error(S3Error(400, "InvalidRequest", str(e)))
        except (OSError, KeyError, grpc.RpcError, RuntimeError) as e:
            self._error(S3Error(500, "InternalError", str(e)))
        finally:
            release()
            self._reply = orig_reply
            self._splice_headers = None

    def do_GET(self):
        self._dispatch()

    def do_HEAD(self):
        self._dispatch()

    def do_PUT(self):
        streaming = self._streaming_put_body()
        if streaming is not None:
            try:
                self._dispatch(streaming)
            finally:
                # keep-alive safety: an aborted upload must not leave body
                # bytes in the stream to be parsed as the next request
                streaming.finish(self)
            return
        self._dispatch(self._read_body())

    def _streaming_put_body(self) -> StreamingBody | None:
        """An open-access plain object PUT streams its body off the socket
        (O(window) gateway memory); anything carrying a signature, SSE,
        aws-chunked framing, a copy source, or a subresource query takes
        the buffered path, which needs the whole payload anyway."""
        if not self.s3.verifier.open_access:
            return None
        url = urllib.parse.urlparse(self.path)
        if url.query:
            return None  # subresources / multipart parts / presigned
        parts = urllib.parse.unquote(url.path).lstrip("/").split("/", 1)
        if len(parts) < 2 or not parts[0] or not parts[1] or parts[1].endswith("/"):
            return None  # bucket ops and directory keys move no body
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        if self.headers.get("x-amz-copy-source"):
            return None
        if (self.headers.get("x-amz-content-sha256") or "").startswith("STREAMING-"):
            return None  # aws-chunked framing needs the buffered decoder
        if sse_mod.has_sse_headers(self.headers):
            return None  # whole-object encryption cannot stream
        length = int(self.headers.get("Content-Length", "0") or 0)
        if length <= 0:
            return None
        import ssl

        # the raw client socket goes along so the native PUT splice can
        # relay body bytes client->volume; never under TLS (the native
        # loop reads raw fds, not the SSL record layer)
        conn = None if isinstance(self.connection, ssl.SSLSocket) else self.connection
        return StreamingBody(self.rfile, length, connection=conn)

    def do_POST(self):
        self._dispatch(self._read_body())

    def do_DELETE(self):
        self._dispatch()

    def do_OPTIONS(self):
        """CORS preflight — matched purely against the bucket's CORS
        config, no SigV4 required (reference cors middleware)."""
        _url, q, bucket, key = self._route()
        origin = self.headers.get("Origin", "")
        req_method = self.headers.get("Access-Control-Request-Method", "")
        req_headers = self.headers.get("Access-Control-Request-Headers", "")
        if not origin or not req_method:
            self._error(S3Error(400, "InvalidRequest", "not a CORS preflight"))
            return
        try:
            hdrs = self.s3.cors_response_headers(
                bucket, origin, req_method, req_headers
            )
        except S3Error as e:
            self._error(e)
            return
        if hdrs is None:
            self._error(S3Error(403, "AccessForbidden", "CORSResponse: no rule matches"))
            return
        self._reply(200, headers=hdrs)

    # ---- verb impls ------------------------------------------------------
    def _do_get(self, q, bucket, key, body):
        if not bucket:
            self._send_xml(self.s3.list_buckets())
            return
        if not key:
            if "policy" in q:
                blob = self.s3.bucket_config(bucket, "policy")
                if not blob:
                    raise S3Error(404, "NoSuchBucketPolicy", bucket)
                self._reply(200, blob, "application/json")
                return
            if "cors" in q:
                blob = self.s3.bucket_config(bucket, "cors")
                if not blob:
                    raise S3Error(404, "NoSuchCORSConfiguration", bucket)
                self._send_xml(blob)
                return
            if "versioning" in q:
                root = ET.Element("VersioningConfiguration", xmlns=XMLNS)
                state = self.s3.versioning_state(bucket)
                if state:
                    _el(root, "Status", state)
                self._send_xml(_xml(root))
                return
            if "location" in q:
                self.s3.require_bucket(bucket)
                root = ET.Element("LocationConstraint", xmlns=XMLNS)
                self._send_xml(_xml(root))
                return
            if "versions" in q:
                self._send_xml(
                    self.s3.list_object_versions(
                        bucket,
                        prefix=q.get("prefix", [""])[0],
                        max_keys=int(q.get("max-keys", ["1000"])[0]),
                        key_marker=q.get("key-marker", [""])[0],
                        version_id_marker=q.get("version-id-marker", [""])[0],
                    )
                )
                return
            if "uploads" in q:
                self._send_xml(self.s3.list_multipart_uploads(bucket))
                return
            if "acl" in q:
                self._send_xml(self.s3.get_bucket_acl_xml(bucket))
                return
            if "lifecycle" in q:
                self._send_xml(self.s3.get_lifecycle_xml(bucket))
                return
            if "tagging" in q:
                self.s3.require_bucket(bucket)
                blob = self.s3.bucket_config(bucket, "tagging")
                if not blob:
                    raise S3Error(404, "NoSuchTagSet", bucket)
                self._send_xml(blob)
                return
            if "website" in q:
                self.s3.require_bucket(bucket)
                blob = self.s3.bucket_config(bucket, "website")
                if not blob:
                    raise S3Error(
                        404, "NoSuchWebsiteConfiguration", bucket
                    )
                self._send_xml(blob)
                return
            self._send_xml(
                self.s3.list_objects(
                    bucket,
                    prefix=q.get("prefix", [""])[0],
                    delimiter=q.get("delimiter", [""])[0],
                    max_keys=int(q.get("max-keys", ["1000"])[0]),
                    start_after=q.get("start-after", [q.get("marker", [""])[0]])[0],
                    v2=q.get("list-type", [""])[0] == "2",
                    continuation=q.get("continuation-token", [""])[0],
                )
            )
            return
        if "uploadId" in q:
            self._send_xml(self.s3.list_parts(bucket, key, q["uploadId"][0]))
            return
        if "acl" in q:
            self._send_xml(self.s3.get_object_acl_xml(bucket, key))
            return
        if "tagging" in q:
            self._send_xml(self.s3.get_tagging(bucket, key))
            return
        if "retention" in q:
            self._send_xml(
                self.s3.get_retention(bucket, key, q.get("versionId", [""])[0])
            )
            return
        if "legal-hold" in q:
            self._send_xml(
                self.s3.get_legal_hold(bucket, key, q.get("versionId", [""])[0])
            )
            return
        entry = self.s3.get_object_entry(bucket, key, q.get("versionId", [""])[0])
        etag = (entry.extended.get("etag") or b"").decode()
        extra = {
            "ETag": f'"{etag}"',
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(entry.attr.mtime)
            ),
            **{
                k: v.decode()
                for k, v in entry.extended.items()
                if k.startswith("x-amz-meta-")
            },
        }
        vid = (entry.extended.get("version_id") or b"").decode()
        if vid:
            extra["x-amz-version-id"] = vid
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        if sse_mod.is_encrypted(entry.extended) or self.headers.get(
            sse_mod.HDR_CUSTOMER_ALGO
        ):
            if self.command == "HEAD":
                # size + key validation come from metadata; downloading
                # and decrypting a whole object for a HEAD is waste
                try:
                    sse_hdrs = sse_mod.head_headers(self.headers, entry.extended)
                except sse_mod.SseError as e:
                    raise S3Error(e.status, e.code, str(e))
                self.reply_ranged(
                    sse_mod.display_size(entry.extended, entry.size),
                    entry.attr.mime or "binary/octet-stream",
                    lambda lo, hi: b"",
                    extra_headers={**extra, **sse_hdrs},
                )
                return
            # GCM is all-or-nothing: materialize, decrypt, then range
            sealed = chunk_reader.read_entry(self.s3.master, entry)
            try:
                plain, sse_hdrs = sse_mod.decrypt_for_get(
                    self.headers, entry.extended, sealed, self.s3.kms
                )
            except sse_mod.SseError as e:
                raise S3Error(e.status, e.code, str(e))
            self.reply_ranged(
                len(plain),
                entry.attr.mime or "binary/octet-stream",
                lambda lo, hi: plain[lo : hi + 1],
                extra_headers={**extra, **sse_hdrs},
            )
            return
        from seaweedfs_tpu_torch.filer import splice as native_splice

        mime = entry.attr.mime or "binary/octet-stream"

        def _splice(status, lo, hi, headers):
            # native zero-copy relay volume->client (filer/splice.py),
            # hot-chunk cache tier first (x-weed-cache attribution);
            # splice_entry records status and delivered bytes on the
            # handler itself for the metrics and access log
            return native_splice.splice_entry(
                self, self.s3.master, entry, status, lo, hi, mime, headers,
                cache=self.s3.chunk_cache,
            )

        self.reply_ranged(
            entry.size,
            mime,
            lambda lo, hi: chunk_reader.read_entry(
                self.s3.master, entry, lo, hi - lo + 1
            ),
            extra_headers=extra,
            # body streams through the chunk-prefetch window (and the
            # hot-chunk cache): GET of a multi-chunk object holds K
            # chunks, not the object
            stream=lambda lo, hi: chunk_reader.stream_entry(
                self.s3.master, entry, lo, hi - lo + 1,
                chunk_cache=self.s3.chunk_cache,
            ),
            splice=_splice,
        )

    def _do_head(self, q, bucket, key, body):
        if not key:
            self.s3.require_bucket(bucket)
            self._reply(200)
            return
        self._do_get(q, bucket, key, body)

    def _do_put(self, q, bucket, key, body):
        if key and "partNumber" in q and "uploadId" in q:
            part_source = self.headers.get("x-amz-copy-source")
            if part_source:
                self._authorize_copy_source(part_source)
                etag, mtime = self.s3.upload_part_copy(
                    bucket,
                    q["uploadId"][0],
                    int(q["partNumber"][0]),
                    part_source,
                    self.headers.get("x-amz-copy-source-range", ""),
                    headers=self.headers,
                )
                root = ET.Element("CopyPartResult", xmlns=XMLNS)
                _el(root, "ETag", f'"{etag}"')
                _el(root, "LastModified", _iso(mtime))
                self._send_xml(_xml(root))
                return
            etag = self.s3.put_part(
                bucket, q["uploadId"][0], int(q["partNumber"][0]), body,
                headers=self.headers,
            )
            self._reply(200, headers={"ETag": f'"{etag}"'})
            return
        if key and "acl" in q:
            canned = self.headers.get("x-amz-acl", "")
            if canned:
                self._reject_mixed_acl_forms()
                self.s3.put_object_acl(bucket, key, canned)
            else:
                self.s3.put_object_acl_grants(
                    bucket, key, self._acl_grants_from_request(body)
                )
            self._reply(200)
            return
        if key and "tagging" in q:
            self.s3.put_tagging(bucket, key, body)
            self._reply(200)
            return
        if key and "retention" in q:
            self.s3.put_retention(
                bucket,
                key,
                q.get("versionId", [""])[0],
                body,
                bypass_governance=(
                    self.headers.get("x-amz-bypass-governance-retention", "")
                    .lower() == "true"
                ),
            )
            self._reply(200)
            return
        if key and "legal-hold" in q:
            self.s3.put_legal_hold(
                bucket, key, q.get("versionId", [""])[0], body
            )
            self._reply(200)
            return
        if not key:
            if "policy" in q:
                from seaweedfs_tpu_torch.s3 import policy as policy_mod

                try:
                    policy_mod.parse_policy(body)
                except policy_mod.PolicyError as e:
                    raise S3Error(400, "MalformedPolicy", str(e))
                self.s3.set_bucket_config(bucket, "policy", body)
                self._reply(204)
                return
            if "cors" in q:
                from seaweedfs_tpu_torch.s3 import cors as cors_mod

                try:
                    cors_mod.parse_cors(body)
                except cors_mod.CorsError as e:
                    raise S3Error(400, "MalformedXML", str(e))
                self.s3.set_bucket_config(bucket, "cors", body)
                self._reply(200)
                return
            if "tagging" in q:
                self.s3.require_bucket(bucket)
                _parse_bucket_tagging_xml(body)  # validate before store
                self.s3.set_bucket_config(bucket, "tagging", body)
                self._reply(204)
                return
            if "website" in q:
                self.s3.require_bucket(bucket)
                _parse_website_xml(body)
                self.s3.set_bucket_config(bucket, "website", body)
                self._reply(200)
                return
            if "versioning" in q:
                status = _parse_status_xml(
                    body, "VersioningConfiguration",
                    accepted=("Enabled", "Suspended"),
                )
                self.s3.set_bucket_config(bucket, "versioning", status.encode())
                self._reply(200)
                return
            if "lifecycle" in q:
                self.s3.put_lifecycle(bucket, body)
                self._reply(200)
                return
            if "acl" in q:
                canned = self.headers.get("x-amz-acl", "")
                if canned:
                    self._reject_mixed_acl_forms()
                    self.s3.put_bucket_acl(bucket, canned)
                else:
                    self.s3.put_bucket_acl_grants(
                        bucket, self._acl_grants_from_request(body)
                    )
                self._reply(200)
                return
            self.s3.create_bucket(bucket)
            canned = self.headers.get("x-amz-acl", "")
            if canned:
                # create-bucket --acl must not silently produce private
                self.s3.put_bucket_acl(bucket, canned)
            self._reply(200, headers={"Location": f"/{bucket}"})
            return
        source = self.headers.get("x-amz-copy-source")
        if source:
            self._authorize_copy_source(source)
            canned = self.headers.get("x-amz-acl", "")
            if canned:
                S3ApiServer.validate_canned_acl(canned)
            etag, mtime = self.s3.copy_object(
                bucket, key, source, headers=self.headers
            )
            if canned:
                # copies default private; an explicit header applies to
                # the NEW object, never inherited from the source
                self.s3.put_object_acl(bucket, key, canned)
            root = ET.Element("CopyObjectResult", xmlns=XMLNS)
            _el(root, "ETag", f'"{etag}"')
            _el(root, "LastModified", _iso(mtime))
            self._send_xml(_xml(root))
            return
        from seaweedfs_tpu_torch.s3 import sse as sse_mod

        if isinstance(body, StreamingBody):
            # streaming bodies are only minted when no SSE headers ride
            # the request (_streaming_put_body) — nothing to seal
            sse_meta, sse_hdrs = {}, {}
        else:
            try:
                body, sse_meta, sse_hdrs = sse_mod.encrypt_for_put(
                    self.headers, body, self.s3.kms
                )
            except sse_mod.SseError as e:
                raise S3Error(e.status, e.code, str(e))
        extra_meta = dict(sse_meta)
        if self.headers.get("x-amz-tagging"):
            extra_meta["tagging"] = S3ApiServer.parse_tag_header(
                self.headers["x-amz-tagging"]
            )
        canned = self.headers.get("x-amz-acl", "")
        if canned:
            # create-with-acl must not silently produce private
            S3ApiServer.validate_canned_acl(canned)
            if canned != "private":
                extra_meta["acl"] = canned.encode()
        etag, vid = self.s3.put_object(
            bucket,
            key,
            body,
            self.headers.get("Content-Type", ""),
            {**self._meta_headers(), **extra_meta},
        )
        hdrs = {"ETag": f'"{etag}"', **sse_hdrs}
        if vid:
            hdrs["x-amz-version-id"] = vid
        # PUT-side plane attribution: which plane moved the body, and how
        # long the batched replica acks took after the last body byte
        if getattr(body, "px_spliced", 0):
            hdrs["x-weed-spliced"] = "1"
            hdrs["x-weed-put-ack-us"] = str(getattr(body, "px_ack_ns", 0) // 1000)
        self._reply(200, headers=hdrs)

    def _do_post(self, q, bucket, key, body):
        if key and "uploads" in q:
            from seaweedfs_tpu_torch.s3 import sse as sse_mod

            try:
                sse_meta = sse_mod.upload_sse_meta(self.headers, self.s3.kms)
            except sse_mod.SseError as e:
                raise S3Error(e.status, e.code, str(e)) from e
            self._send_xml(
                self.s3.create_multipart(
                    bucket, key, self.headers.get("Content-Type", ""),
                    canned_acl=self.headers.get("x-amz-acl", ""),
                    sse_meta=sse_meta,
                )
            )
            return
        if key and "uploadId" in q:
            self._send_xml(
                self.s3.complete_multipart(bucket, key, q["uploadId"][0], body)
            )
            return
        if not key and "delete" in q:
            self._multi_delete(bucket, body)
            return
        if key and "select" in q:
            self._select_content(bucket, key, body)
            return
        if not key and not q and self._is_form_post():
            self._post_policy_upload(bucket, body)
            return
        self._error(S3Error(400, "InvalidRequest", "unsupported POST"))

    def _is_form_post(self) -> bool:
        return (
            (self.headers.get("Content-Type") or "")
            .lower()
            .startswith("multipart/form-data")
        )

    def _post_policy_upload(self, bucket: str, body: bytes):
        """Browser form upload (reference
        s3api_object_handlers_postpolicy.go): credentials ride the form
        as a signed policy document, not the request headers."""
        from seaweedfs_tpu_torch.s3 import policy as policy_mod
        from seaweedfs_tpu_torch.s3 import post_policy

        try:
            fields, filename, file_bytes = post_policy.parse_form(
                self.headers.get("Content-Type", ""), body
            )
            key = post_policy.resolve_key(fields, filename)
            principal = "*"
            if self.s3.verifier.identities:
                ident = post_policy.verify_signature(
                    fields, self.s3.verifier.identities
                )
                principal = ident.access_key
                post_policy.check_policy(
                    fields, bucket, key, len(file_bytes)
                )
        except post_policy.PolicyError as e:
            raise S3Error(400, "InvalidPolicyDocument", str(e))
        # the dispatch-time checks ran with the bucket ARN and no key —
        # re-apply the object-scoped guards now that the key is known
        bentry = self.s3.filer.find_entry(self.s3.bucket_path(bucket))
        if bentry is not None:
            if bentry.extended.get("quota_readonly"):
                raise S3Error(
                    403, "QuotaExceeded",
                    f"bucket {bucket} is over its configured quota",
                )
            doc = _parse_policy_blob(bentry.extended.get("policy"))
            decision = policy_mod.evaluate(
                doc,
                "s3:PutObject",
                f"arn:aws:s3:::{bucket}/{key}",
                principal,
                self._policy_context(principal) if doc else None,
            )
            if decision == policy_mod.DENY:
                raise AccessDenied("explicit deny by bucket policy")
        lf = {k.lower(): v for k, v in fields.items()}
        content_type = lf.get("content-type", "")
        # metadata fields (x-amz-meta-*) ride the form like headers would
        meta = {
            k: v.encode()
            for k, v in lf.items()
            if k.startswith("x-amz-meta-")
        }
        etag, _vid = self.s3.put_object(
            bucket, key, file_bytes, content_type, meta
        )
        status_field = lf.get("success_action_status", "204")
        status = int(status_field) if status_field in ("200", "201", "204") else 204
        if status == 201:
            root = ET.Element("PostResponse")
            _el(root, "Bucket", bucket)
            _el(root, "Key", key)
            _el(root, "ETag", f'"{etag}"')
            self._reply(
                201, _xml(root), "application/xml", headers={"ETag": f'"{etag}"'}
            )
        else:
            self._reply(status, headers={"ETag": f'"{etag}"'})

    def _select_content(self, bucket: str, key: str, body: bytes):
        """SelectObjectContent subset (reference weed/query/): JSON-lines
        input, SELECT/WHERE/LIMIT; the result streams back as plain JSON
        lines rather than the AWS event-stream framing."""
        from seaweedfs_tpu_torch.query import SelectError, execute_select

        req = ET.fromstring(body.decode()) if body.strip() else None
        expression = ""
        in_fmt, out_fmt = "json", None
        delimiter, header_info = ",", "NONE"  # S3's FileHeaderInfo default
        if req is not None:
            ns = {"s3": XMLNS} if req.tag.startswith("{") else {}

            def find(path):
                return (
                    req.find("/".join(f"s3:{p}" for p in path.split("/")), ns)
                    if ns
                    else req.find(path)
                )

            def findtext(path):
                el = find(path)
                return el.text if el is not None and el.text else ""

            expression = findtext("Expression")
            csv_in = find("InputSerialization/CSV")
            if csv_in is not None:
                in_fmt = "csv"
                delimiter = findtext("InputSerialization/CSV/FieldDelimiter") or ","
                header_info = (
                    findtext("InputSerialization/CSV/FileHeaderInfo") or "NONE"
                )
            if find("OutputSerialization/CSV") is not None:
                out_fmt = "csv"
            elif find("OutputSerialization/JSON") is not None:
                out_fmt = "json"
        if not expression:
            raise S3Error(400, "MissingRequiredParameter", "Expression")
        entry = self.s3.get_object_entry(bucket, key)
        data = chunk_reader.read_entry(self.s3.master, entry)
        try:
            result = execute_select(
                expression,
                data,
                input_format=in_fmt,
                output_format=out_fmt,
                field_delimiter=delimiter,
                file_header_info=header_info,
            )
        except SelectError as e:
            raise S3Error(400, "InvalidTextRepresentation", str(e))
        ctype = "text/csv" if (out_fmt or in_fmt) == "csv" else "application/json"
        self._reply(200, result, ctype)

    def _multi_delete(self, bucket: str, body: bytes):
        req = ET.fromstring(body.decode())
        ns = {"s3": XMLNS} if req.tag.startswith("{") else {}
        keys = [
            (o.findtext("s3:Key", namespaces=ns) if ns else o.findtext("Key"))
            for o in (
                req.findall("s3:Object", namespaces=ns)
                if ns
                else req.findall("Object")
            )
        ]
        root = ET.Element("DeleteResult", xmlns=XMLNS)
        for k in keys:
            if not k:
                continue
            try:
                self.s3.delete_object(bucket, k)
                d = _el(root, "Deleted")
                _el(d, "Key", k)
            except S3Error as e:
                er = _el(root, "Error")
                _el(er, "Key", k)
                _el(er, "Code", e.code)
                _el(er, "Message", str(e))
        self._send_xml(_xml(root))

    def _do_delete(self, q, bucket, key, body):
        if key and "uploadId" in q:
            self.s3.abort_multipart(bucket, q["uploadId"][0])
            self._reply(204)
            return
        if key and "tagging" in q:
            self.s3.delete_tagging(bucket, key)
            self._reply(204)
            return
        if not key:
            if "policy" in q:
                self.s3.set_bucket_config(bucket, "policy", None)
                self._reply(204)
                return
            if "lifecycle" in q:
                self.s3.delete_lifecycle(bucket)
                self._reply(204)
                return
            if "cors" in q:
                self.s3.set_bucket_config(bucket, "cors", None)
                self._reply(204)
                return
            if "tagging" in q:
                self.s3.set_bucket_config(bucket, "tagging", None)
                self._reply(204)
                return
            if "website" in q:
                self.s3.set_bucket_config(bucket, "website", None)
                self._reply(204)
                return
            self.s3.delete_bucket(bucket)
            self._reply(204)
            return
        if "versionId" in q:
            # WORM enforcement lives inside delete_object_version (one
            # entry fetch): GOVERNANCE bypassable by authorized callers
            # via x-amz-bypass-governance-retention, COMPLIANCE never
            self.s3.delete_object_version(
                bucket,
                key,
                q["versionId"][0],
                bypass_governance=(
                    self.headers.get("x-amz-bypass-governance-retention", "")
                    .lower() == "true"
                ),
                authenticated=(
                    getattr(self, "_principal", "*") != "*"
                    or self.s3.verifier.open_access
                ),
            )
            self._reply(204, headers={"x-amz-version-id": q["versionId"][0]})
            return
        marker_vid = self.s3.delete_object(bucket, key)
        hdrs = {}
        if marker_vid:
            hdrs = {"x-amz-delete-marker": "true", "x-amz-version-id": marker_vid}
        self._reply(204, headers=hdrs)
