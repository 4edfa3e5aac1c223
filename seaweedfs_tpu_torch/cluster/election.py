"""Lease-style master leader election over HTTP liveness probes: the
port's copy of seaweedfs_tpu/cluster/election.py.

Each master polls every peer's `/cluster/ping` endpoint; the lowest
(http_address-ordered) live master is the leader.  Election state feeds
the `leader` field of HeartbeatResponse (the seam the reference's Raft
fills, weed/server/master_grpc_server.go), so volume servers re-home to
the new leader within one probe interval + one heartbeat reconnect.
"""

from __future__ import annotations

import http.client
import json
import threading


class LeaderElection:
    # consecutive failed probes before a peer is demoted: a single slow or
    # dropped ping must not flip leadership (split-brain flap)
    DEMOTE_AFTER = 3

    def __init__(
        self,
        self_http: str,
        self_grpc: str,
        peers: list[str] | None = None,
        interval: float = 1.0,
        probe_timeout: float = 1.0,
        on_peer_state=None,
        on_leader=None,
    ):
        self.self_http = self_http
        self.self_grpc = self_grpc
        self._peers: list[str] = [p for p in (peers or []) if p != self_http]
        self._lock = threading.Lock()
        self.interval = interval
        self.probe_timeout = probe_timeout
        # observer for full ping payloads (e.g. sequence-watermark adoption)
        self.on_peer_state = on_peer_state
        # called when a probe makes this master the leader, before any
        # caller sees it lead (the master's sequence jump on takeover)
        self.on_leader = on_leader
        # http addr -> grpc addr for live peers (self always present)
        self._alive: dict[str, str] = {self_http: self_grpc}
        self._fail_counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- peer management (ports are often dynamic in tests) -------------
    @property
    def peers(self) -> list[str]:
        with self._lock:
            return list(self._peers)

    def set_peers(self, peers: list[str]) -> None:
        with self._lock:
            self._peers = [p for p in peers if p != self.self_http]

    # ---- state -----------------------------------------------------------
    @property
    def leader_http(self) -> str:
        with self._lock:
            return min(self._alive)

    @property
    def leader_grpc(self) -> str:
        with self._lock:
            return self._alive[min(self._alive)]

    @property
    def is_leader(self) -> bool:
        return self.leader_http == self.self_http

    def alive(self) -> dict[str, str]:
        with self._lock:
            return dict(self._alive)

    # ---- probing ---------------------------------------------------------
    def _probe(self, peer_http: str) -> dict | None:
        """-> the peer's ping payload, or None if unreachable.

        Deliberately NOT pooled: a liveness probe asks "does this peer
        accept new connections", and a stopped server's per-connection
        handler threads keep answering on an established keep-alive
        socket long after server_close() — a pooled probe would report a
        dead leader alive forever and block takeover."""
        host, port = peer_http.rsplit(":", 1)
        # a pooled keep-alive conn keeps a stopped master "alive" on lingering
        # handler threads, so the liveness probe must use a fresh socket
        # weedlint: disable=W008 — liveness probe requires a fresh socket (see above)
        conn = http.client.HTTPConnection(host, int(port), timeout=self.probe_timeout)
        try:
            conn.request("GET", "/cluster/ping")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            info = json.loads(resp.read())
            return info if info.get("grpc_address") else None
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    def probe_once(self) -> None:
        results: dict[str, dict | None] = {p: self._probe(p) for p in self.peers}
        with self._lock:
            alive = {self.self_http: self.self_grpc}
            for p, info in results.items():
                if info is not None:
                    self._fail_counts[p] = 0
                    alive[p] = info["grpc_address"]
                else:
                    self._fail_counts[p] = self._fail_counts.get(p, 0) + 1
                    # hysteresis: keep a known-alive peer until it misses
                    # DEMOTE_AFTER consecutive probes
                    if (
                        p in self._alive
                        and self._fail_counts[p] < self.DEMOTE_AFTER
                    ):
                        alive[p] = self._alive[p]
            takeover = min(alive) == self.self_http != min(self._alive)
        if takeover and self.on_leader:
            self.on_leader()
        with self._lock:
            self._alive = alive
        if self.on_peer_state:
            for info in results.values():
                if info is not None:
                    self.on_peer_state(info)

    # ---- loop ------------------------------------------------------------
    def start(self) -> None:
        if not self.peers:
            return  # single-master: self is leader, no probing needed
        self.probe_once()
        self._thread = threading.Thread(
            target=self._loop, name="leader-election", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.probe_once()
