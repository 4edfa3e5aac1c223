"""Filer server: HTTP file API + gRPC metadata service.

HTTP surface mirrors the reference's filer server handlers
(weed/server/filer_server_handlers_write.go:72 PostHandler
with autochunking, filer_server_handlers_read.go GET with streaming,
directory JSON listings): POST/PUT uploads chunk through the master to
volume servers; GET streams files or lists directories; DELETE removes
entries (?recursive=true for trees).  gRPC implements the weedtpu.filer
contract (pb/filer.proto) for programmatic clients (S3 gateway, sync).

The port's copy of seaweedfs_tpu/server/filer_server.py: the same routes,
status codes, messages, JSON listings, gRPC contract and
``weedtpu_filer_request*`` metrics.  The filer runs no kernel and takes no
device.  Its HTTP handlers run in server spans joined to the caller's
``traceparent``, each metadata gRPC verb records into its ``meta.*``
latency sketch (stats/sketch.py), and ``tls_cert``/``tls_key`` put the
HTTP listener behind TLS (its gRPC is mutual TLS when ``WEEDTPU_TLS_*``
are set, as every server's; rpc.py).  A GET of a chunked file tries the
native splice first (filer/splice.py: chunk views relayed volume->client by
csrc/dp.cpp's px verbs; never over TLS, and not with
``SEAWEEDFS_TPU_NATIVE_PX=0``); a splice library that cannot be built or
loaded fails ``start``.  ``notify`` names a replication bus
(replication/notification.make_bus: ``log:<file>``, ``webhook:<url>``)
that sees every metadata event in order; it is closed by ``stop``.
"""

from __future__ import annotations

import json
import mimetypes
import threading
import time
from urllib.parse import parse_qs, unquote, urlparse

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.filer import Filer
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.filer.filer import FilerError
from seaweedfs_tpu_torch.filer import manifest as chunk_manifest
from seaweedfs_tpu_torch.filer import reader as chunk_reader
from seaweedfs_tpu_torch.filer import upload as chunk_upload
from seaweedfs_tpu_torch.pb import filer_pb2 as f_pb
from seaweedfs_tpu_torch.stats import sketch
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler, StreamingBody
from seaweedfs_tpu_torch.wdclient import MasterClient


class FilerGrpcServicer:
    def __init__(self, fs: "FilerServer"):
        self.fs = fs

    # each metadata verb records into its meta.* op-class sketch: the
    # server-observed latencies the SLO engine evaluates

    def lookup_directory_entry(self, request, context):
        t0 = time.perf_counter()
        try:
            path = request.directory.rstrip("/") + "/" + request.name
            entry = self.fs.filer.find_entry(path)
            if entry is None:
                return f_pb.LookupDirectoryEntryResponse(error=f"{path} not found")
            return f_pb.LookupDirectoryEntryResponse(entry=entry.to_pb())
        finally:
            sketch.record(sketch.OP_META_LOOKUP, time.perf_counter() - t0)

    def list_entries(self, request, context):
        t0 = time.perf_counter()
        try:
            entries = self.fs.filer.list_entries(
                request.directory,
                start_file_name=request.start_from_file_name,
                inclusive=request.inclusive_start_from,
                limit=request.limit or 1024,
                prefix=request.prefix,
            )
        finally:
            # the store scan is the listing's cost; the yield loop below
            # runs at the client's consumption pace
            sketch.record(sketch.OP_META_LIST, time.perf_counter() - t0)
        for e in entries:
            yield f_pb.ListEntriesResponse(entry=e.to_pb())

    def create_entry(self, request, context):
        t0 = time.perf_counter()
        try:
            entry = Entry.from_pb(request.directory, request.entry)
            self.fs.filer.create_entry(entry)
        except (FilerError, ValueError) as e:
            return f_pb.CreateEntryResponse(error=str(e))
        finally:
            sketch.record(sketch.OP_META_CREATE, time.perf_counter() - t0)
        return f_pb.CreateEntryResponse()

    def update_entry(self, request, context):
        t0 = time.perf_counter()
        try:
            self.fs.filer.update_entry(Entry.from_pb(request.directory, request.entry))
        except (FilerError, ValueError) as e:
            return f_pb.UpdateEntryResponse(error=str(e))
        finally:
            sketch.record(sketch.OP_META_UPDATE, time.perf_counter() - t0)
        return f_pb.UpdateEntryResponse()

    def delete_entry(self, request, context):
        t0 = time.perf_counter()
        path = request.directory.rstrip("/") + "/" + request.name
        try:
            self.fs.filer.delete_entry(
                path,
                recursive=request.is_recursive,
                delete_data=request.is_delete_data,
            )
        except FileNotFoundError:
            pass  # idempotent, like the reference
        except FilerError as e:
            return f_pb.DeleteEntryResponse(error=str(e))
        finally:
            sketch.record(sketch.OP_META_DELETE, time.perf_counter() - t0)
        return f_pb.DeleteEntryResponse()

    def atomic_rename_entry(self, request, context):
        t0 = time.perf_counter()
        old = request.old_directory.rstrip("/") + "/" + request.old_name
        new = request.new_directory.rstrip("/") + "/" + request.new_name
        try:
            self.fs.filer.rename(old, new)
        except (FileNotFoundError, FilerError) as e:
            return f_pb.AtomicRenameEntryResponse(error=str(e))
        finally:
            sketch.record(sketch.OP_META_RENAME, time.perf_counter() - t0)
        return f_pb.AtomicRenameEntryResponse()

    def assign_volume(self, request, context):
        try:
            resp = self.fs.master.assign(
                count=request.count or 1,
                collection=request.collection,
                replication=request.replication,
                ttl_seconds=request.ttl_seconds,
            )
        except Exception as e:  # noqa: BLE001
            return f_pb.AssignVolumeResponse(error=str(e))
        return f_pb.AssignVolumeResponse(
            fid=resp.fid,
            url=resp.location.url,
            public_url=resp.location.public_url or resp.location.url,
            count=resp.count,
            auth=resp.auth,
        )

    def statistics(self, request, context):
        files, dirs = self.fs.filer.statistics()
        return f_pb.FilerStatisticsResponse(entry_count=files, directory_count=dirs)

    def subscribe_metadata(self, request, context):
        since = request.since_ts_ns
        log = self.fs.filer.meta_log
        while context.is_active() and not self.fs._stopping.is_set():
            events = self.fs.filer.read_meta_events(since, request.path_prefix)
            for ev in events:
                since = max(since, ev.ts_ns)
                yield f_pb.MetadataEvent(
                    ts_ns=ev.ts_ns,
                    directory=ev.directory,
                    old_entry=ev.old_entry.to_pb() if ev.old_entry else None,
                    new_entry=ev.new_entry.to_pb() if ev.new_entry else None,
                    new_parent_path=ev.new_parent_path,
                )
            if not events:
                with log.lock:
                    log.cond.wait(timeout=0.5)


class _FilerHttpHandler(QuietHandler):
    fs: "FilerServer" = None

    def _path_q(self):
        url = urlparse(self.path)
        return unquote(url.path), parse_qs(url.query)

    # ---- read -----------------------------------------------------------
    def do_GET(self):
        stats.FILER_REQUESTS.inc(type="read")
        t0 = time.perf_counter()
        try:
            with self.server_span("read", "filer"):
                self._get_inner()
        finally:
            stats.FILER_REQUEST_SECONDS.observe(
                time.perf_counter() - t0, type="read"
            )

    def _get_inner(self):
        path, q = self._path_q()
        entry = self.fs.filer.find_entry(path)
        if entry is None:
            self._reply(404, b"not found", "text/plain")
            return
        if entry.is_directory:
            self._list_dir(path, q)
            return
        from seaweedfs_tpu_torch.filer import splice as native_splice

        mime = entry.attr.mime or "application/octet-stream"
        try:
            self.reply_ranged(
                entry.size,
                mime,
                lambda lo, hi: chunk_reader.read_entry(
                    self.fs.master, entry, lo, hi - lo + 1
                ),
                # stream through the chunk-prefetch window: a multi-chunk
                # file never materializes in filer memory
                stream=lambda lo, hi: chunk_reader.stream_entry(
                    self.fs.master, entry, lo, hi - lo + 1
                ),
                # native zero-copy relay first (filer/splice.py): chunk
                # bodies go volume->client without surfacing in CPython
                splice=lambda status, lo, hi, headers: native_splice.splice_entry(
                    self, self.fs.master, entry, status, lo, hi, mime, headers
                ),
            )
        except (IOError, OSError, KeyError, grpc.RpcError) as e:
            # chunk holder unreachable / vid vanished — surface as 500
            # instead of aborting the connection mid-handler
            self._reply(500, str(e).encode(), "text/plain")

    do_HEAD = do_GET  # reply_ranged answers HEAD from entry.size, no chunk I/O

    def _list_dir(self, path: str, q):
        limit = int(q.get("limit", ["1024"])[0])
        last = q.get("lastFileName", [""])[0]
        entries = self.fs.filer.list_entries(path, start_file_name=last, limit=limit)
        listing = {
            "Path": path,
            "Entries": [
                {
                    "FullPath": e.full_path,
                    "IsDirectory": e.is_directory,
                    "FileSize": e.size,
                    "Mtime": e.attr.mtime,
                    "Mime": e.attr.mime,
                    "Chunks": len(e.chunks),
                }
                for e in entries
            ],
            "Limit": limit,
            "LastFileName": entries[-1].name if entries else "",
            "ShouldDisplayLoadMore": len(entries) >= limit,
        }
        self._reply(200, json.dumps(listing, indent=2).encode(), "application/json")

    # ---- write ----------------------------------------------------------
    def do_POST(self):
        self._upload()

    def do_PUT(self):
        self._upload()

    def _upload(self):
        stats.FILER_REQUESTS.inc(type="write")
        t0 = time.perf_counter()
        try:
            with self.server_span("write", "filer"):
                self._upload_inner()
        finally:
            stats.FILER_REQUEST_SECONDS.observe(
                time.perf_counter() - t0, type="write"
            )

    def _upload_inner(self):
        path, q = self._path_q()
        if path.endswith("/"):
            # bare directory creation — a frozen subtree refuses these too
            rule = self.fs.conf.get().match(path)
            if rule is not None and rule.read_only:
                self._reply(
                    403, b"read-only location (fs.configure)", "text/plain"
                )
                return
            self.fs.filer.mkdirs(path)
            self._reply(201, b"{}", "application/json")
            return
        length = int(self.headers.get("Content-Length", "0") or 0)
        # the body streams off the socket into the uploader's bounded
        # window — the filer never materializes the whole file
        body = StreamingBody(self.rfile, length)
        try:
            self._upload_body(path, q, body)
        finally:
            # keep-alive safety: refused/failed uploads must not leave
            # body bytes in the stream to be parsed as the next request
            body.finish(self)

    def _upload_body(self, path: str, q, body: StreamingBody) -> None:
        collection = q.get("collection", [""])[0]
        replication = q.get("replication", [""])[0]
        ttl = int(q.get("ttl", ["0"])[0] or 0)
        disk_type = q.get("diskType", [""])[0]
        growth_count = 0
        # per-path rules (fs.configure): explicit query params win, the
        # matched location rule fills the rest (reference filer_conf.go
        # MatchStorageRule on the upload path)
        rule = self.fs.conf.get().match(path)
        if rule is not None:
            if rule.read_only:
                self._reply(
                    403, b"read-only location (fs.configure)", "text/plain"
                )
                return
            name = path.rsplit("/", 1)[-1]
            if (
                rule.max_file_name_length
                and len(name) > rule.max_file_name_length
            ):
                self._reply(
                    400,
                    b"file name exceeds configured maximum length",
                    "text/plain",
                )
                return
            collection = collection or rule.collection
            replication = replication or rule.replication
            ttl = ttl or rule.ttl_seconds
            disk_type = disk_type or rule.disk_type
            growth_count = rule.volume_growth_count
        mime_hint = self.headers.get("Content-Type") or (
            mimetypes.guess_type(path)[0] or ""
        )
        try:
            chunks, content, etag = chunk_upload.upload_stream(
                self.fs.master,
                body,
                fid_pool=self.fs.fid_pool,
                chunk_size=self.fs.chunk_size,
                collection=collection,
                replication=replication,
                ttl_seconds=ttl,
                disk_type=disk_type,
                growth_count=growth_count,
                mime=mime_hint,
            )
            chunks = chunk_manifest.maybe_manifestize(
                lambda blob: chunk_upload.save_blob(
                    self.fs.master,
                    blob,
                    collection=collection,
                    replication=replication,
                    ttl_seconds=ttl,
                    disk_type=disk_type,
                    growth_count=growth_count,
                ),
                chunks,
                self.fs.manifest_batch,
            )
            mime = mime_hint
            entry = Entry(
                full_path=path,
                attr=Attr.now(
                    mime=mime, collection=collection, replication=replication,
                    ttl_seconds=ttl,
                ),
                chunks=chunks,
                content=content,
            )
            # insert first, then reclaim superseded chunks: concurrent
            # readers of the old entry must not hit deleted fids, and an
            # insert failure must not destroy the existing file's data
            old = self.fs.filer.find_entry(path)
            self.fs.filer.create_entry(entry)
            if old is not None and not old.is_directory:
                self.fs.filer._delete_chunks(old)
        except (FilerError, OSError, RuntimeError, grpc.RpcError) as e:
            # covers IOError upload failures, wdclient AssignError
            # (RuntimeError), and master-unreachable gRPC errors
            self._reply(500, str(e).encode(), "text/plain")
            return
        self._reply(
            201,
            json.dumps({"name": entry.name, "size": entry.size, "eTag": etag}).encode(),
            "application/json",
            headers={"ETag": f'"{etag}"'},
        )

    def do_DELETE(self):
        stats.FILER_REQUESTS.inc(type="delete")
        t0 = time.perf_counter()
        try:
            with self.server_span("delete", "filer"):
                self._delete_inner()
        finally:
            stats.FILER_REQUEST_SECONDS.observe(
                time.perf_counter() - t0, type="delete"
            )

    def _delete_inner(self):
        path, q = self._path_q()
        rule = self.fs.conf.get().match(path)
        if rule is not None and rule.read_only:
            self._reply(
                403, b"read-only location (fs.configure)", "text/plain"
            )
            return
        recursive = q.get("recursive", ["false"])[0] == "true"
        try:
            self.fs.filer.delete_entry(path, recursive=recursive)
        except FileNotFoundError:
            self._reply(404, b"not found", "text/plain")
            return
        except FilerError as e:
            self._reply(409, str(e).encode(), "text/plain")
            return
        self._reply(204)


class FilerServer:
    """One filer process: HTTP file API + gRPC metadata service."""

    def __init__(
        self,
        master_address: str,
        *,
        port: int = 0,
        grpc_port: int = 0,
        store=None,
        store_path: str | None = None,
        chunk_size: int = chunk_upload.DEFAULT_CHUNK_SIZE,
        manifest_batch: int = chunk_manifest.MANIFEST_BATCH,
        meta_log_dir: str | None = None,
        ip: str = "127.0.0.1",
        tls_cert: str = "",
        tls_key: str = "",
        notify: str = "",
    ):
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("the filer's HTTPS needs both tls_cert and tls_key")
        if tls_cert:
            from seaweedfs_tpu_torch.security.tls import server_ssl_context

            # fail fast, before anything binds: a pair that does not load
            # must never leave a plaintext listener behind
            server_ssl_context(tls_cert, tls_key)
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.master = MasterClient(master_address)
        bus = None
        if notify:
            from seaweedfs_tpu_torch.replication.notification import make_bus

            bus = make_bus(notify)  # an unknown bus refuses before any store opens
        if store is None and store_path:
            from seaweedfs_tpu_torch.filer import make_store

            store = make_store(store_path)
        self.filer = Filer(
            store=store, master_client=self.master, meta_log_dir=meta_log_dir
        )
        self._notifier = None
        if bus is not None:
            from seaweedfs_tpu_torch.replication.notification import Notifier

            self._notifier = self.filer.notifier = Notifier(bus)
        self.chunk_size = chunk_size
        # cross-request assign batching (filer/upload.FidPool)
        self.fid_pool = chunk_upload.FidPool(self.master)
        # per-path rules (fs.configure): /etc/seaweedfs/filer.conf in the
        # filer itself, TTL-cached for the upload hot path
        from seaweedfs_tpu_torch.filer.filer_conf import ConfCache

        self.conf = ConfCache(self.filer)
        self.manifest_batch = manifest_batch
        self.ip = ip
        self._port = port
        # sibling servers' convention: gRPC port defaults to HTTP port+10000
        self._grpc_port = grpc_port or (port + 10000 if port else 0)
        self._stopping = threading.Event()
        self._httpd: PooledHTTPServer | None = None
        self._grpc_server = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self._grpc_port}"

    def start(self) -> None:
        from seaweedfs_tpu_torch.native import dataplane

        dataplane.require_px()  # an enabled splice that cannot load fails here
        handler = type("Handler", (_FilerHttpHandler,), {"fs": self})
        self._httpd = PooledHTTPServer((self.ip, self._port), handler)
        if self.tls_cert:
            from seaweedfs_tpu_torch.security.tls import wrap_http_server

            wrap_http_server(self._httpd, self.tls_cert, self.tls_key)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

        self._grpc_server = rpc.make_server()
        rpc.add_service(self._grpc_server, f_pb, "Filer", FilerGrpcServicer(self))
        self._grpc_port = rpc.add_port(self._grpc_server, f"{self.ip}:{self._grpc_port}")
        self._grpc_server.start()

    def stop(self) -> None:
        self._stopping.set()
        if self._notifier is not None:
            self._notifier.close()
        with self.filer.meta_log.lock:
            self.filer.meta_log.cond.notify_all()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._grpc_server:
            self._grpc_server.stop(grace=1).wait()
        if self.filer.persist_log is not None:
            self.filer.persist_log.close()
        self.filer.store.close()
