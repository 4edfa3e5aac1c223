"""HTTP server and handler base for the port's master and volume server:
the port's copy of seaweedfs_tpu/util/httpd.py's ``PooledHTTPServer`` and
``QuietHandler`` (quiet logging, TCP_NODELAY, length-aware replies and
single-range RFC 7233 replies).

Not ported: graceful drain, request ids, streamed and spliced bodies, and
the tracing span (the port has no tracing layer yet).
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from seaweedfs_tpu_torch.util.http_range import RangeNotSatisfiable, parse_range


class PooledHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer tuned for data-plane load: the stdlib's 5-entry
    listen backlog drops connections (ECONNRESET) under concurrent
    bursts."""

    request_queue_size = 128
    daemon_threads = True


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
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def reply_ranged(self, size: int, ctype: str, fetch: Callable[[int, int], bytes],
                     extra_headers: dict | None = None) -> None:
        """Serve a body of ``size`` bytes honoring the request's Range
        header: 206 + Content-Range for a satisfiable range, 416 for an
        unsatisfiable one, 200 otherwise.  ``fetch(lo, hi)`` materializes
        the inclusive byte range; HEAD replies from ``size`` alone.
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
        self._reply(status, fetch(lo, hi) if size else b"", ctype, headers=headers)
