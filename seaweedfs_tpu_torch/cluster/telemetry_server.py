"""Telemetry collector server — the receiving side of cluster telemetry.

The port's copy of seaweedfs_tpu/cluster/telemetry_server.py, with the
same routes and bodies.  Counterpart of the reference's telemetry/server/
(main.go:45-52 routes, api/handlers.go CollectTelemetry/GetStats/
GetInstances, storage/prometheus.go gauges): accepts the leader masters'
snapshots at POST /api/collect, keeps the latest report per cluster
(bounded, stale-expired), and serves

  * GET /api/stats     — fleet totals (clusters, servers, volumes)
  * GET /api/instances — per-cluster latest snapshots
  * GET /metrics       — Prometheus text (per-cluster gauges), scrape
                         target for the shipped Grafana-style dashboards

The reporter side is cluster/telemetry.py (leader-only POSTs)."""

from __future__ import annotations

import json
import threading
import time

from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler

_FIELDS = ("volume_servers", "volumes", "ec_shards", "filers", "brokers")


class _TelemetryHandler(QuietHandler):
    srv: "TelemetryServer" = None

    def _json(self, obj, code=200):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_POST(self):
        if self.path != "/api/collect":
            self._drain()  # keep-alive: unread bodies desync the stream
            self._json({"error": "not found"}, 404)
            return
        length = int(self.headers.get("Content-Length", "0") or 0)
        if length > 1 << 20:
            # draining an attacker-chosen Content-Length would pin the
            # handler; drop the connection instead of reading the body
            self.close_connection = True
            self._json({"error": "report too large"}, 413)
            return
        try:
            doc = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._json({"error": "bad json"}, 400)
            return
        try:
            self.srv.collect(doc)
        except ValueError as e:
            self._json({"error": str(e)}, 400)
            return
        self._json({"ok": True})

    def do_GET(self):
        if self.path == "/api/stats":
            self._json(self.srv.stats())
        elif self.path == "/api/instances":
            self._json({"instances": self.srv.instances()})
        elif self.path == "/metrics":
            self._reply(
                200,
                self.srv.prometheus().encode(),
                "text/plain; version=0.0.4",
            )
        else:
            self._json({"error": "not found"}, 404)


class TelemetryServer:
    """Bounded latest-per-cluster collector (no historical store — the
    Prometheus scrape IS the history, like the reference's design)."""

    def __init__(
        self,
        *,
        ip: str = "127.0.0.1",
        port: int = 0,
        max_clusters: int = 10_000,
        stale_after: float = 24 * 3600.0,
    ):
        self.ip = ip
        self._port = port
        self.max_clusters = max_clusters
        self.stale_after = stale_after
        self._clusters: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._httpd: PooledHTTPServer | None = None
        self.received = 0

    # ---- ingestion -------------------------------------------------------
    def collect(self, doc: dict) -> None:
        cid = str(doc.get("cluster_id", ""))[:128]
        if not cid:
            raise ValueError("report missing cluster_id")
        snap = {"cluster_id": cid, "received_at": time.time()}
        snap["version"] = str(doc.get("version", ""))[:64]
        for f in _FIELDS:
            try:
                snap[f] = max(0, int(doc.get(f, 0)))
            except (TypeError, ValueError):
                snap[f] = 0
        with self._lock:
            self._expire_locked()
            if cid not in self._clusters and len(self._clusters) >= self.max_clusters:
                raise ValueError("collector at capacity")
            self._clusters[cid] = snap
            self.received += 1

    def _expire_locked(self) -> None:
        # received_at is exported wall-clock; day-scale staleness
        # tolerates clock steps  # weedlint: disable=W005 — compares persisted wall-clock report times
        horizon = time.time() - self.stale_after
        dead = [
            cid
            for cid, s in self._clusters.items()
            if s["received_at"] < horizon
        ]
        for cid in dead:
            del self._clusters[cid]

    # ---- queries ---------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            self._expire_locked()
            snaps = list(self._clusters.values())
        out = {"clusters": len(snaps), "reports_received": self.received}
        for f in _FIELDS:
            out["total_" + f] = sum(s[f] for s in snaps)
        return out

    def instances(self) -> list[dict]:
        with self._lock:
            self._expire_locked()
            return sorted(
                self._clusters.values(), key=lambda s: s["cluster_id"]
            )

    def prometheus(self) -> str:
        lines = [
            "# HELP weedtpu_telemetry_clusters clusters reporting",
            "# TYPE weedtpu_telemetry_clusters gauge",
        ]
        with self._lock:
            self._expire_locked()
            snaps = list(self._clusters.values())
        lines.append(f"weedtpu_telemetry_clusters {len(snaps)}")

        def esc(v: str) -> str:
            # Prometheus label escaping: a raw quote/newline from one
            # reporter must not corrupt the whole exposition
            return (
                v.replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        for f in _FIELDS:
            lines.append(f"# TYPE weedtpu_cluster_{f} gauge")
            for s in snaps:
                lines.append(
                    f'weedtpu_cluster_{f}{{cluster="{esc(s["cluster_id"])}"}} {s[f]}'
                )
        return "\n".join(lines) + "\n"

    # ---- lifecycle -------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self) -> str:
        return f"http://{self.ip}:{self.port}"

    def start(self) -> "TelemetryServer":
        handler = type("Handler", (_TelemetryHandler,), {"srv": self})
        self._httpd = PooledHTTPServer((self.ip, self._port), handler)
        threading.Thread(
            target=self._httpd.serve_forever, name="telemetry", daemon=True
        ).start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
