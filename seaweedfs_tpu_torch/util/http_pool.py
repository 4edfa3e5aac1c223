"""Keep-alive HTTP/1.1 connection pool for node-to-node traffic: the
port's copy of seaweedfs_tpu/util/http_pool.py's ``HttpConnectionPool``.

The reference reuses pooled Go http.Client transports for replica fan-out
and uploads; a fresh TCP connect per replicated write is a tax on every
write.  Connections are checked out per (host, port), reused across
requests, and dropped on error with one transparent retry (the peer may
have closed an idle connection).  Pool sockets are TCP_NODELAY like the
servers.  Every request's bytes are billed to the calling plane
(stats/plane).
"""

from __future__ import annotations

import http.client
import socket
import threading
import time

from seaweedfs_tpu_torch.stats import plane


class PoolExhausted(IOError):
    """Checkout waited out its deadline at ``max_per_host``: client-side
    backpressure, NOT a peer failure — callers with replica-failover
    logic must not treat it as a dead host (the peer was never
    contacted)."""


class HttpConnectionPool:
    """``max_per_host`` caps LIVE connections per host (idle + checked
    out): N gateway workers × c client threads against one volume server
    must queue on a cond-var, not exhaust fds — a checkout past the cap
    waits until a connection is returned or retired, then either reuses
    it or replaces it, and gives up with an error at the request
    deadline rather than waiting forever on a wedged peer."""

    def __init__(
        self,
        timeout: float = 10.0,
        max_idle_per_host: int = 8,
        max_per_host: int = 64,
    ):
        self.timeout = timeout
        self.max_idle = max_idle_per_host
        self.max_per_host = max_per_host
        self._idle: dict[str, list[http.client.HTTPConnection]] = {}
        self._live: dict[str, int] = {}  # per-host idle + checked out
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)
        self._closed = False  # _checkin after close() must not repool

    def _checkout(
        self, addr: str, timeout: float | None
    ) -> tuple[http.client.HTTPConnection, bool]:
        """-> (connection, reused): ``reused`` drives the retry policy —
        only a stale pooled socket justifies replaying a request."""
        want = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + want
        waited = False
        with self._lock:
            while True:
                conns = self._idle.get(addr)
                if conns:
                    conn = conns.pop()
                    # time spent waiting at the cap comes OFF the socket
                    # deadline — the caller's timeout must bound the whole
                    # request, not stack wait + I/O budgets (the wait loop
                    # below guarantees a usable remainder).  The no-wait
                    # fast path keeps the exact `want` so the settimeout
                    # dedup below still hits.
                    sock_t = (
                        want if not waited else deadline - time.monotonic()
                    )
                    # track the socket's current deadline so the common case
                    # (same timeout as last use) costs no settimeout syscall,
                    # while a per-request override can never leak to the next
                    # caller
                    if conn.sock is not None and getattr(conn, "_pool_timeout", None) != sock_t:
                        conn.sock.settimeout(sock_t)
                        conn._pool_timeout = sock_t
                    return conn, True
                if self._live.get(addr, 0) < self.max_per_host:
                    # reserve the slot before connecting (outside the lock)
                    self._live[addr] = self._live.get(addr, 0) + 1
                    break
                left = deadline - time.monotonic()
                if left <= 0 or not self._freed.wait(timeout=left):
                    raise PoolExhausted(
                        f"{addr}: connection pool exhausted "
                        f"({self.max_per_host} in flight)"
                    )
                waited = True
                if deadline - time.monotonic() < min(0.25, want / 2):
                    # woken with almost no budget left: stay a
                    # PoolExhausted — a ~50ms socket under exactly the
                    # load that caused the wait would fail as
                    # TimeoutError, which replica-failover callers
                    # misread as a dead peer
                    raise PoolExhausted(
                        f"{addr}: pool slot freed too close to the deadline"
                    )
        try:
            host, port = addr.rsplit(":", 1)
            conn_t = (
                want if not waited else max(0.1, deadline - time.monotonic())
            )
            conn = http.client.HTTPConnection(host, int(port), timeout=conn_t)
            conn.connect()
            conn._pool_timeout = conn_t
            # request() sends headers and body separately; Nagle + delayed ACK
            # would add ~40ms per round trip without this
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            self._retire(addr)  # the reserved slot must not leak
            raise
        return conn, False

    def _retire(self, addr: str) -> None:
        """A live connection died (or never came up): free its slot."""
        with self._lock:
            n = self._live.get(addr, 1) - 1
            if n > 0:
                self._live[addr] = n
            else:
                self._live.pop(addr, None)
            # one condition serves every host: notify_all, or the single
            # wakeup can land on a different host's waiter and be lost
            self._freed.notify_all()

    def _checkin(self, addr: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            conns = self._idle.setdefault(addr, [])
            if not self._closed and len(conns) < self.max_idle:
                conns.append(conn)
                self._freed.notify_all()  # claimable — and the single
                # condition spans hosts, so a lone notify could wake
                # only a different host's waiter
                return
        conn.close()
        self._retire(addr)

    def request(
        self,
        addr: str,
        method: str,
        path: str,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout: float | None = None,
        retries: bool = True,
    ) -> tuple[int, bytes]:
        """-> (status, body); see :meth:`request_meta` for the retry policy."""
        status, _hdrs, data = self.request_meta(
            addr, method, path, body=body, headers=headers, timeout=timeout,
            retries=retries,
        )
        return status, data

    def request_meta(
        self,
        addr: str,
        method: str,
        path: str,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout: float | None = None,
        retries: bool = True,
    ) -> tuple[int, dict[str, str], bytes]:
        """-> (status, response-headers, body); ``timeout`` overrides the
        pool default for this request only.

        Retry policy: a replay happens ONLY for non-timeout failures on
        a reused pooled socket — overwhelmingly the peer-closed-it-idle
        case.  A timeout on a reused socket may mean the peer is
        processing slowly, and a fresh-connection failure is the peer's
        real state; both propagate immediately.  A peer restart can
        leave up to max_idle stale sockets behind, so the loop drains
        them (each failed attempt consumes one) until a fresh
        connection decides.  The narrow processed-then-reset window (the
        peer handled the request, then died before the response left)
        is still replayed — callers whose requests must be AT MOST ONCE
        (task claims, notifications) pass ``retries=False`` and handle
        the stale-socket error themselves."""
        attempts = (self.max_idle + 2) if retries else 1
        for _ in range(attempts):
            conn, reused = self._checkout(addr, timeout)
            try:
                t0 = time.perf_counter()
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
                resp_headers = dict(resp.getheaders())
                if resp.will_close:
                    conn.close()
                    self._retire(addr)
                else:
                    self._checkin(addr, conn)
                # intra-cluster bytes billed to the calling plane (serve
                # vs scrub vs repair ...): request body went out, the
                # response body came back
                nbody = (
                    len(body)
                    if isinstance(body, (bytes, bytearray, memoryview))
                    else 0
                )
                plane.account(nbody, "write", time.perf_counter() - t0)
                plane.account(len(data), "read")
                return resp.status, resp_headers, data
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                self._retire(addr)
                if not retries or not reused or isinstance(e, TimeoutError):
                    raise
            except BaseException:
                # anything else (header ValueError, KeyboardInterrupt in a
                # worker thread, ...) must still free the live slot, or
                # the host wedges in PoolExhausted after max_per_host leaks
                conn.close()
                self._retire(addr)
                raise
        raise IOError(f"{addr}: every pooled connection was stale")

    def close(self) -> None:
        with self._lock:
            # in-flight requests may _checkin after this returns: the
            # flag routes their sockets to close() instead of _idle
            self._closed = True
            for addr, conns in self._idle.items():
                for c in conns:
                    c.close()
                n = self._live.get(addr, 0) - len(conns)
                if n > 0:
                    self._live[addr] = n
                else:
                    self._live.pop(addr, None)
            self._idle.clear()
            self._freed.notify_all()



_shared: HttpConnectionPool | None = None
_shared_lock = threading.Lock()


def shared_pool() -> HttpConnectionPool:
    """The process-wide pool (lazy; one per process, like the reference's
    shared http.Client transport): the shell's volume.check.disk and
    volume.repair.status requests ride it."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = HttpConnectionPool(timeout=30.0, max_idle_per_host=16)
        return _shared
