"""HTTP server and handler base for the port's master, volume server and
filer: the port's copy of seaweedfs_tpu/util/httpd.py's ``PooledHTTPServer``,
``QuietHandler`` (quiet logging, TCP_NODELAY, length-aware replies,
single-range RFC 7233 replies, bodies streamed piece by piece) and
``StreamingBody`` (a request body read off the socket on demand).

``PooledHTTPServer(reuse_port=True)`` binds with SO_REUSEPORT, and
``PooledHTTPServer.drain`` waits out the requests in flight after a
shutdown (graceful drain).
``QuietHandler.server_span`` opens a request's server span from its
``traceparent`` header (stats/trace.py), and every reply carries an
``X-Request-ID`` (``response_request_id``: the caller's, echoed when it
validates, else a fresh one).  ``security/tls.wrap_http_server`` turns a
bound server into HTTPS.

The native splice's hooks (filer/splice.py): ``StreamingBody.connection``,
``take_buffered`` and ``pushback`` let a PUT body leave through the raw
socket and come back untouched when the splice falls back, and
``reply_ranged(splice=)`` tries the native relay first on a GET.
"""

from __future__ import annotations

import random
import re
import socket
import threading
import time
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
    upload aborts early.

    ``connection`` (optional) is the raw client socket for the native PUT
    splice, set only when the native loop may write the fd directly (never
    under TLS).  ``take_buffered``/``pushback`` let the splice drain
    Python's read-ahead buffer first and return it untouched when it falls
    back to the Python path."""

    def __init__(self, rfile, length: int, connection: socket.socket | None = None):
        self._rfile = rfile
        self.length = length
        self.remaining = length
        self.connection = connection
        self._pushed = b""

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        want = self.remaining if n is None or n < 0 else min(n, self.remaining)
        if self._pushed:
            data, self._pushed = self._pushed[:want], self._pushed[want:]
            self.remaining -= len(data)
            if len(data) < want:  # top up from the stream proper
                data += self.read(want - len(data))
            return data
        data = self._rfile.read(want)
        if not data:  # peer cut the stream short of Content-Length
            self.remaining = 0
            return b""
        self.remaining -= len(data)
        return data

    def take_buffered(self) -> bytes:
        """Body bytes Python's buffered reader already holds (at most one
        raw read happens if its buffer is empty): the native splice must
        relay these before it touches the raw socket."""
        if self.remaining <= 0:
            return b""
        if self._pushed:
            return self.read(len(self._pushed))
        try:
            held = self._rfile.peek()
        except (OSError, ValueError, AttributeError):
            return b""
        take = min(len(held), self.remaining)
        return self.read(take) if take else b""

    def pushback(self, data: bytes) -> None:
        """Return already-consumed bytes to the front of the stream (the
        native splice's no-harm fallback): read() serves them first."""
        if data:
            self._pushed = data + self._pushed
            self.remaining += len(data)

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
        # graceful-drain state: requests (not connections) in flight, so an
        # idle keep-alive connection cannot stall a drain forever
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._draining = False
        super().__init__(server_address, handler_class)

    def server_bind(self):
        if self.reuse_port:
            if not hasattr(socket, "SO_REUSEPORT"):
                raise OSError("SO_REUSEPORT is not available on this platform")
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()

    # graceful drain: the teardown order is shutdown() -> server_close() ->
    # drain(); the closed listen socket stops new connections at the
    # kernel, then drain() waits for handlers that already parsed a request
    # to finish replying

    def request_begin(self) -> bool:
        """Count one parsed request in flight.  True while the server is
        draining: the handler finishes this response and then closes the
        connection instead of waiting for another."""
        with self._inflight_cv:
            self._inflight += 1
            return self._draining

    def request_end(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_cv.notify_all()

    @property
    def inflight(self) -> int:
        with self._inflight_cv:
            return self._inflight

    def drain(self, timeout: float = 5.0) -> int:
        """Wait up to ``timeout`` seconds for in-flight requests to
        complete; returns the number still running when the wait ends
        (0: a clean drain).  A request that arrives on an accepted
        keep-alive connection during the drain is served and told to
        close the connection afterwards."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            self._draining = True
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._inflight_cv.wait(left)
            return self._inflight


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

    # drain accounting (PooledHTTPServer.drain): a request is in flight
    # from the parse of its request line until the handler method returns
    _drain_counted = False

    def parse_request(self):
        ok = super().parse_request()
        if ok:
            begin = getattr(self.server, "request_begin", None)
            if begin is not None:
                self._drain_counted = True
                if begin():  # draining: no more keep-alive after this one
                    self.close_connection = True
        return ok

    def handle_one_request(self):
        self._drain_counted = False
        try:
            super().handle_one_request()
        finally:
            if self._drain_counted:
                self._drain_counted = False
                end = getattr(self.server, "request_end", None)
                if end is not None:
                    end()

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
                     stream: Callable[[int, int], Iterable[bytes]] | None = None,
                     splice: Callable[[int, int, int, dict | None], bool] | None = None) -> None:
        """Serve a body of ``size`` bytes honoring the request's Range
        header: 206 + Content-Range for a satisfiable range, 416 for an
        unsatisfiable one, 200 otherwise.  ``fetch(lo, hi)`` materializes
        the inclusive byte range; when ``stream(lo, hi)`` is given the
        body goes out piece by piece instead (Content-Length framed: a
        multi-chunk file never materializes in server memory).  HEAD
        replies from ``size`` alone without calling either.
        ``extra_headers`` ride on every non-416 response.

        ``splice(status, lo, hi, headers)`` is tried first on a GET: the
        native zero-copy relay (filer/splice.py).  It returns True when it
        handled the response (headers included), False when nothing was
        sent and the Python path serves instead."""
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
        if splice is not None and size and self.command == "GET":
            if splice(status, lo, hi, headers):
                return
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
