"""HTTP server and handler base for the port's master, volume server and
filer: the port's copy of seaweedfs_tpu/util/httpd.py's ``PooledHTTPServer``,
``QuietHandler`` (quiet logging, TCP_NODELAY, length-aware replies,
single-range RFC 7233 replies, bodies streamed piece by piece) and
``StreamingBody`` (a request body read off the socket on demand).

``PooledHTTPServer(reuse_port=True)`` binds with SO_REUSEPORT.
``QuietHandler.server_span`` opens a request's server span from its
``traceparent`` header (stats/trace.py), and every reply carries an
``X-Request-ID`` (``response_request_id``: the caller's, echoed when it
validates, else a fresh one).  ``security/tls.wrap_http_server`` turns a
bound server into HTTPS.

Not ported: graceful drain and the native splice's hooks
(``StreamingBody.take_buffered``/``pushback``, ``reply_ranged(splice=)``;
ROADMAP Queue A item 9).
"""

from __future__ import annotations

import random
import re
import socket
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable

from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.http_range import RangeNotSatisfiable, parse_range

_RID_RE = re.compile(r"[A-Za-z0-9._-]{1,64}")


def response_request_id(headers) -> str:
    """The X-Request-ID a response should carry: the caller's id echoed
    when it validates (one id follows a request across server hops; a raw
    echo would inject response headers), else a fresh PRNG handle."""
    rid = headers.get("X-Request-ID", "") if headers is not None else ""
    if rid and _RID_RE.fullmatch(rid):
        return rid
    return f"{random.getrandbits(64):016x}"


class StreamingBody:
    """A request body read off the socket on demand (sized by
    Content-Length): the filer hands this to the chunk uploader so an
    upload streams through a bounded window instead of materializing.

    ``len()`` reports the declared length; ``remaining`` tracks unread
    bytes so the handler can keep the keep-alive stream parseable when an
    upload aborts early."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self.length = length
        self.remaining = length

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        want = self.remaining if n is None or n < 0 else min(n, self.remaining)
        data = self._rfile.read(want)
        if not data:  # peer cut the stream short of Content-Length
            self.remaining = 0
            return b""
        self.remaining -= len(data)
        return data

    def __len__(self) -> int:
        return self.length

    def finish(self, handler: BaseHTTPRequestHandler, drain_limit: int = 1 << 20) -> None:
        """Restore keep-alive framing after the handler replied: drain a
        small unread remainder, or cut the connection when draining an
        aborted large upload would cost more than a reconnect."""
        if self.remaining <= 0:
            return
        if self.remaining > drain_limit:
            handler.close_connection = True
            self.remaining = 0
            return
        while self.read(65536):
            pass


class PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer tuned for data-plane load: the stdlib's 5-entry
    listen backlog drops connections (ECONNRESET) under concurrent
    bursts.

    ``reuse_port=True`` binds with SO_REUSEPORT so several processes can
    share one listen address and the kernel spreads accepted connections
    across them (the S3 gateway's ``-reusePort``)."""

    request_queue_size = 128
    daemon_threads = True

    def __init__(self, server_address, handler_class, *, reuse_port: bool = False):
        self.reuse_port = reuse_port
        super().__init__(server_address, handler_class)

    def server_bind(self):
        if self.reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError("SO_REUSEPORT is not available on this platform")
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class QuietHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # headers and body go out in separate send()s; without TCP_NODELAY the
    # Nagle/delayed-ACK interaction adds a ~40 ms floor to every response
    disable_nagle_algorithm = True
    # per-socket-op deadline: a client that stalls mid-request must not pin
    # a worker forever
    timeout = 120

    def log_message(self, *args):
        pass

    def server_span(self, name: str, service: str, **attrs):
        """Server span for this request, seeded from its ``traceparent``
        header (stats/trace.py): the HTTP half of cross-server context
        propagation.  Use as ``with self.server_span("read", "volume"):``."""
        from seaweedfs_tpu_torch.stats import trace

        return trace.span(name, service=service, headers=self.headers, attrs=attrs or None)

    def _drain(self, length: int | None = None) -> None:
        """Consume an unread request body.  A handler that replies without
        reading the body leaves the bytes in the keep-alive stream, where
        they get parsed as the next request line."""
        if length is None:
            length = int(self.headers.get("Content-Length", "0") or 0)
        while length > 0:
            chunk = self.rfile.read(min(65536, length))
            if not chunk:
                break
            length -= len(chunk)

    def _reply(self, code: int, body: bytes = b"", ctype: str = "application/octet-stream",
               headers: dict | None = None, length: int | None = None) -> None:
        """Send a full response; ``length`` overrides Content-Length for
        bodyless replies that must advertise a size (HEAD)."""
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body) if length is None else length))
        self.send_header("X-Request-ID", response_request_id(self.headers))
        if self.close_connection:
            # an earlier framing decision ends the connection after this
            # response: advertise it so clients do not race a silently
            # closed keep-alive socket with their next request
            self.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def reply_ranged(self, size: int, ctype: str, fetch: Callable[[int, int], bytes] | None,
                     extra_headers: dict | None = None,
                     stream: Callable[[int, int], Iterable[bytes]] | None = None) -> None:
        """Serve a body of ``size`` bytes honoring the request's Range
        header: 206 + Content-Range for a satisfiable range, 416 for an
        unsatisfiable one, 200 otherwise.  ``fetch(lo, hi)`` materializes
        the inclusive byte range; when ``stream(lo, hi)`` is given the
        body goes out piece by piece instead (Content-Length framed: a
        multi-chunk file never materializes in server memory).  HEAD
        replies from ``size`` alone without calling either.
        ``extra_headers`` ride on every non-416 response."""
        extra = extra_headers or {}
        try:
            rng = parse_range(self.headers.get("Range"), size)
        except RangeNotSatisfiable as e:
            self._reply(416, b"", headers={"Content-Range": f"bytes */{e.size}"})
            return
        if self.command == "HEAD":
            headers = dict(extra)
            if rng:
                headers["Content-Range"] = f"bytes {rng[0]}-{rng[1]}/{size}"
            self._reply(206 if rng else 200, b"", ctype, headers=headers or None,
                        length=(rng[1] - rng[0] + 1) if rng else size)
            return
        if rng is None:
            status, lo, hi, headers = 200, 0, size - 1, extra or None
        else:
            lo, hi = rng
            status = 206
            headers = {**extra, "Content-Range": f"bytes {lo}-{hi}/{size}"}
        if stream is not None and size:
            self._reply_streamed(status, lo, hi, ctype, headers, stream)
            return
        self._reply(status, fetch(lo, hi) if size else b"", ctype, headers=headers)

    def _reply_streamed(self, status, lo, hi, ctype, headers, stream) -> None:
        """Send an inclusive [lo, hi] body as pieces from ``stream``.  The
        first piece is pulled *before* the status line goes out, so the
        common upstream failures (dead volume holder, vanished vid) still
        produce a clean error response; once headers are sent the only
        honest signal left for a failure is cutting the connection short
        of Content-Length."""
        total = hi - lo + 1
        it = iter(stream(lo, hi))
        try:
            first = next(it)
        except StopIteration:
            first = b""
        self._reply(status, first, ctype, headers=headers, length=total)
        sent = len(first)
        try:
            for piece in it:
                if piece:
                    self.wfile.write(piece)
                    sent += len(piece)
        except OSError:
            self.close_connection = True  # client went away mid-body
            return
        except Exception as e:  # noqa: BLE001 — headers are out; see docstring
            wlog.warning("streamed reply aborted after %d/%d bytes: %s", sent, total, e)
            self.close_connection = True
            return
        if sent != total:
            self.close_connection = True
