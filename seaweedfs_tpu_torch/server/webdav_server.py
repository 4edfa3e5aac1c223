"""WebDAV gateway over the filer.

Counterpart of the reference's weed/server/webdav_server.go (golang.org/
x/net/webdav bound to a filer-backed FileSystem): here the DAV protocol
surface is implemented directly on the framework's HTTP handler base —
OPTIONS/PROPFIND/MKCOL/GET/HEAD/PUT/DELETE/MOVE/COPY — and rides the
same WeedFS client plumbing the mount uses, so locking semantics and
chunking match everywhere else.

The port's copy of seaweedfs_tpu/server/webdav_server.py.
"""

from __future__ import annotations

import io
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate

from seaweedfs_tpu_torch.filer import reader as chunk_reader
from seaweedfs_tpu_torch.filer import upload as chunk_upload
from seaweedfs_tpu_torch.filer.entry import Attr, Entry
from seaweedfs_tpu_torch.mount.filer_client import FilerClient, FilerError
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler, StreamingBody

DAV_NS = "DAV:"


def _prop_xml(href: str, entry: Entry | None, is_root: bool = False) -> ET.Element:
    resp = ET.Element(f"{{{DAV_NS}}}response")
    ET.SubElement(resp, f"{{{DAV_NS}}}href").text = href
    propstat = ET.SubElement(resp, f"{{{DAV_NS}}}propstat")
    prop = ET.SubElement(propstat, f"{{{DAV_NS}}}prop")
    is_dir = is_root or (entry is not None and entry.is_directory)
    rtype = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
    if is_dir:
        ET.SubElement(rtype, f"{{{DAV_NS}}}collection")
    if entry is not None and not is_dir:
        ET.SubElement(prop, f"{{{DAV_NS}}}getcontentlength").text = str(entry.size)
        if entry.attr.mime:
            ET.SubElement(prop, f"{{{DAV_NS}}}getcontenttype").text = entry.attr.mime
    mtime = entry.attr.mtime if entry is not None else 0.0
    ET.SubElement(prop, f"{{{DAV_NS}}}getlastmodified").text = formatdate(
        mtime, usegmt=True
    )
    ET.SubElement(propstat, f"{{{DAV_NS}}}status").text = "HTTP/1.1 200 OK"
    return resp


class _DavHandler(QuietHandler):
    dav: "WebDavServer" = None

    def _path(self) -> str:
        return urllib.parse.unquote(urllib.parse.urlparse(self.path).path)

    def _abs(self, path: str) -> str:
        root = self.dav.root
        path = "/" + path.strip("/")
        return path if root == "/" else root + (path if path != "/" else "")

    def do_OPTIONS(self):
        self._reply(
            200,
            headers={
                "DAV": "1,2",
                "Allow": "OPTIONS, PROPFIND, MKCOL, GET, HEAD, PUT, "
                         "DELETE, MOVE, COPY",
                "MS-Author-Via": "DAV",
            },
        )

    def do_PROPFIND(self):
        self._drain()
        path = self._path()
        full = self._abs(path)
        depth = self.headers.get("Depth", "1")
        client = self.dav.client
        is_root = full == self.dav.root
        entry = None if is_root else client.lookup(full)
        if not is_root and entry is None:
            self._reply(404, b"not found", "text/plain")
            return
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        ms.append(_prop_xml(path, entry, is_root=is_root))
        if depth != "0" and (is_root or entry.is_directory):
            for child in client.list(full):
                href = path.rstrip("/") + "/" + child.name
                ms.append(_prop_xml(href, child))
        body = b'<?xml version="1.0" encoding="utf-8"?>' + ET.tostring(ms)
        self._reply(207, body, 'application/xml; charset="utf-8"')

    def do_MKCOL(self):
        self._drain()
        full = self._abs(self._path())
        if self.dav.client.lookup(full) is not None:
            self._reply(405, b"exists", "text/plain")
            return
        self.dav.client.create(
            Entry(full, is_directory=True, attr=Attr.now(mode=0o755))
        )
        self._reply(201)

    def do_GET(self):
        full = self._abs(self._path())
        entry = self.dav.client.lookup(full)
        if entry is None:
            self._reply(404, b"not found", "text/plain")
            return
        if entry.is_directory:
            names = "\n".join(e.name for e in self.dav.client.list(full))
            self._reply(200, names.encode(), "text/plain")
            return
        self.reply_ranged(
            entry.size,
            entry.attr.mime or "application/octet-stream",
            lambda lo, hi: chunk_reader.read_entry(
                self.dav.client.master, entry, lo, hi - lo + 1
            ),
            # stream through the chunk-prefetch window: DAV GETs of large
            # files never materialize in gateway memory
            stream=lambda lo, hi: chunk_reader.stream_entry(
                self.dav.client.master, entry, lo, hi - lo + 1
            ),
        )

    do_HEAD = do_GET

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", "0") or 0)
        body = StreamingBody(self.rfile, length)
        try:
            self._put_inner(body)
        finally:
            body.finish(self)  # keep-alive framing survives failed uploads

    def _put_inner(self, body: StreamingBody):
        full = self._abs(self._path())
        chunks, content, _etag = chunk_upload.upload_stream(
            self.dav.client.master,
            body,
            chunk_size=self.dav.chunk_size,
            mime=self.headers.get("Content-Type", ""),
            fid_pool=self.dav.fid_pool,
        )
        entry = Entry(
            full,
            attr=Attr.now(mime=self.headers.get("Content-Type", "")),
            chunks=chunks,
            content=content,
        )
        old = self.dav.client.lookup(full)
        try:
            self.dav.client.create(entry)
        except FilerError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        if old is not None and not old.is_directory and old.chunks:
            # insert-then-reclaim: overwrites must not leak the old chunks
            self.dav.client.reclaim_chunks(old)
        self._reply(204 if old is not None else 201)

    def do_DELETE(self):
        full = self._abs(self._path())
        entry = self.dav.client.lookup(full)
        if entry is None:
            self._reply(404, b"not found", "text/plain")
            return
        try:
            self.dav.client.delete(full, recursive=True)
        except FilerError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        self._reply(204)

    def _destination(self) -> str | None:
        dest = self.headers.get("Destination", "")
        if not dest:
            return None
        return urllib.parse.unquote(urllib.parse.urlparse(dest).path)

    def do_MOVE(self):
        self._drain()
        dest = self._destination()
        if dest is None:
            self._reply(400, b"Destination required", "text/plain")
            return
        src = self._abs(self._path())
        if self._abs(dest) == src:
            # RFC 4918: a self-move is forbidden — and reclaiming "the
            # overwritten destination" here would destroy the source
            self._reply(403, b"source equals destination", "text/plain")
            return
        if self.dav.client.lookup(src) is None:
            self._reply(404, b"not found", "text/plain")
            return
        # MOVE onto an existing file: its chunks must be reclaimed, the
        # rename's upsert only replaces the metadata
        old = self.dav.client.lookup(self._abs(dest))
        try:
            self.dav.client.rename(src, self._abs(dest))
        except FilerError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        if old is not None and not old.is_directory and old.chunks:
            self.dav.client.reclaim_chunks(old)
        self._reply(201)

    def do_COPY(self):
        self._drain()
        dest = self._destination()
        if dest is None:
            self._reply(400, b"Destination required", "text/plain")
            return
        src = self._abs(self._path())
        entry = self.dav.client.lookup(src)
        if entry is None or entry.is_directory:
            self._reply(404, b"not found or a collection", "text/plain")
            return
        data = chunk_reader.read_entry(self.dav.client.master, entry)
        chunks, content, _ = chunk_upload.upload_stream(
            self.dav.client.master,
            io.BytesIO(data),
            chunk_size=self.dav.chunk_size,
            mime=entry.attr.mime,
        )
        old = self.dav.client.lookup(self._abs(dest))
        try:
            self.dav.client.create(
                Entry(
                    self._abs(dest),
                    attr=Attr.now(mime=entry.attr.mime),
                    chunks=chunks,
                    content=content,
                )
            )
        except FilerError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        if old is not None and not old.is_directory and old.chunks:
            self.dav.client.reclaim_chunks(old)
        self._reply(201)


class WebDavServer:
    def __init__(
        self,
        filer_grpc: str,
        master_grpc: str,
        *,
        port: int = 0,
        ip: str = "127.0.0.1",
        root: str = "/",
        chunk_size: int = chunk_upload.DEFAULT_CHUNK_SIZE,
        tls_cert: str = "",
        tls_key: str = "",
    ):
        self.tls_cert, self.tls_key = tls_cert, tls_key
        self.client = FilerClient(filer_grpc, master_grpc)
        self.root = root.rstrip("/") or "/"
        self.chunk_size = chunk_size
        self.fid_pool = chunk_upload.FidPool(self.client.master)
        self.ip = ip
        self._port = port
        self._httpd: PooledHTTPServer | None = None

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> None:
        ET.register_namespace("D", DAV_NS)
        handler = type("Handler", (_DavHandler,), {"dav": self})
        self._httpd = PooledHTTPServer((self.ip, self._port), handler)
        if self.tls_cert and self.tls_key:
            from seaweedfs_tpu_torch.security.tls import wrap_http_server

            wrap_http_server(self._httpd, self.tls_cert, self.tls_key)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
