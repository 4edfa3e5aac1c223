"""Cross-process entry-cache invalidation bus for SO_REUSEPORT gateway
workers.

N gateway worker processes share one listen socket; each keeps its own
per-process entry cache (filer/entry_cache.py).  A PUT handled by worker
K invalidates K's cache synchronously through the ``Filer.listeners``
seam — this bus extends that seam across the worker group: the mutating
worker publishes the affected paths as loopback UDP datagrams to every
sibling, whose receiver thread drops them from its cache.  Workers stay
coherent with each other within a datagram round trip instead of an
entry-cache TTL.

Datagrams are best-effort by design: a lost datagram degrades to the
TTL bound the cache already enforces (the same staleness contract as an
out-of-band mutation through a shared filer), never to unbounded
staleness.  The parent process binds all N sockets *before* forking so
every worker knows the full peer list with no discovery protocol.

Wire format: one UTF-8 datagram of ``\\n``-joined lines.  A line is
either an absolute entry path (entry-cache invalidation) or
``fid:<vid,needle>`` (hot-chunk cache invalidation — a delete/overwrite
retired that chunk; util/chunk_cache).  Absolute paths always start
with ``/`` so the prefix can never collide.  Lines that would push a
datagram past ~60KB (the loopback UDP payload ceiling) are split across
several datagrams.

The port's copy of seaweedfs_tpu/filer/inval_bus.py: the same wire format,
so each package parses the other's datagrams.
"""

from __future__ import annotations

import socket
import threading

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.util import wlog

_MAX_DGRAM = 60_000  # stay under the 64KB UDP payload limit

# chunk-cache invalidation line marker (entry paths start with "/", so
# the prefix is collision-free); shared with meta_subscriber's stream
FID_PREFIX = "fid:"


class InvalBus:
    """One worker's endpoint on the invalidation group.

    ``sock`` is this worker's pre-bound loopback UDP socket (bound by
    the parent before fork); ``peer_ports`` lists every worker's bus
    port including our own (publishes skip it).
    """

    def __init__(self, sock: socket.socket, peer_ports: list[int]):
        self.sock = sock
        self.port = sock.getsockname()[1]
        self.peer_ports = [p for p in peer_ports if p != self.port]
        self._send_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._closed = False
        self.published = 0
        self.received = 0

    @staticmethod
    def bind() -> socket.socket:
        """One pre-bound loopback endpoint (parent-side, pre-fork)."""
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        return s

    @classmethod
    def group(cls, n: int) -> list[socket.socket]:
        """N pre-bound endpoints for an N-worker group (parent-side)."""
        return [cls.bind() for _ in range(n)]

    # ---- worker side ------------------------------------------------------

    def start(self, on_paths) -> None:
        """Start the receiver: ``on_paths(list[str])`` is called for every
        datagram (the worker's entry-cache invalidator)."""

        def _recv_loop():
            while True:
                try:
                    data = self.sock.recv(65536)
                except OSError:
                    return  # closed
                if self._closed:
                    return  # close() woke us with an empty datagram
                if not data:
                    continue
                stats.INVAL_BUS_DATAGRAMS.inc(direction="received")
                paths = data.decode("utf-8", "replace").split("\n")
                self.received += len(paths)
                try:
                    on_paths([p for p in paths if p])
                except Exception as e:  # noqa: BLE001 — invalidation is advisory; TTL still bounds
                    wlog.warning("inval_bus: handler failed: %s", e)

        self._thread = threading.Thread(
            target=_recv_loop, name="inval-bus", daemon=True
        )
        self._thread.start()

    def publish(self, paths: list[str]) -> None:
        """Fan the mutated paths out to every sibling worker (best
        effort; a send failure degrades to the cache TTL bound)."""
        if not paths or not self.peer_ports:
            return
        batches: list[bytes] = []
        cur: list[bytes] = []
        size = 0
        for p in paths:
            b = p.encode("utf-8")
            if cur and size + len(b) + 1 > _MAX_DGRAM:
                batches.append(b"\n".join(cur))
                cur, size = [], 0
            cur.append(b)
            size += len(b) + 1
        if cur:
            batches.append(b"\n".join(cur))
        with self._send_lock:
            if self._closed:
                return
            for dgram in batches:
                for port in self.peer_ports:
                    try:
                        self.sock.sendto(dgram, ("127.0.0.1", port))
                        stats.INVAL_BUS_DATAGRAMS.inc(direction="sent")
                    except OSError as e:
                        if wlog.V(1):
                            wlog.info("inval_bus: publish to :%d failed: %s", port, e)
                self.published += 1

    def close(self) -> None:
        with self._send_lock:
            self._closed = True
        if self._thread is not None:
            # closing the fd does NOT interrupt a thread blocked in
            # recvfrom on Linux — wake it with an empty datagram instead
            # (it checks _closed after every recv), and only close the fd
            # once the receiver is out of the syscall
            wake = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                wake.sendto(b"", ("127.0.0.1", self.port))
            except OSError:
                pass
            finally:
                wake.close()
            self._thread.join(timeout=2.0)
        self.sock.close()

    def stats(self) -> dict:
        return {
            "port": self.port,
            "peers": len(self.peer_ports),
            "published": self.published,
            "received": self.received,
        }
