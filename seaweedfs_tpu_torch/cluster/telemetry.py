"""Opt-in cluster telemetry from the leader master.

The port's copy of seaweedfs_tpu/cluster/telemetry.py, with the same
report body.  Counterpart of the reference's weed/telemetry/collector.go
(:12-22): the LEADER master periodically POSTs a small anonymous cluster
snapshot (volume/EC/node counts, version) to a configured collector URL.
Off by default; followers never report (leadership churn must not
double-count a cluster).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
import uuid

from seaweedfs_tpu_torch.util import wlog


class TelemetryCollector:
    def __init__(
        self, master, url: str, interval: float = 300.0, cluster_id: str = ""
    ):
        self.master = master
        self.url = urllib.parse.urlparse(url)
        self.interval = interval
        # caller passes a durable id (meta_dir) so failover to another
        # master keeps reporting the SAME cluster; uuid4 is the
        # ephemeral-single-master fallback
        self.cluster_id = cluster_id or uuid.uuid4().hex
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.sent = 0
        self.errors = 0

    def snapshot(self) -> dict:
        topo = self.master.topology
        volumes = ec_shards = 0
        for node in topo.nodes.values():
            volumes += len(getattr(node, "volumes", {}) or {})
        for _vid, shards in getattr(topo, "ec_shard_map", {}).items():
            ec_shards += sum(len(holders) for holders in shards.values())
        return {
            "cluster_id": self.cluster_id,
            "version": "weed-tpu",
            "ts": int(time.time()),
            "is_leader": bool(self.master.is_leader),
            "volume_servers": len(topo.nodes),
            "volumes": volumes,
            "ec_shards": ec_shards,
            "filers": len(self.master.registry.list("filer")),
            "brokers": len(self.master.registry.list("broker")),
        }

    def _post(self, doc: dict) -> None:
        path = self.url.path or "/"
        if self.url.query:
            path += "?" + self.url.query  # collector tokens ride the query
        body = json.dumps(doc).encode()
        headers = {"Content-Type": "application/json"}
        if self.url.scheme == "https":
            # TLS collectors stay on a one-shot HTTPSConnection (the
            # shared pool is plaintext node-to-node transport)
            conn = http.client.HTTPSConnection(
                self.url.hostname, self.url.port or 443, timeout=5
            )
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                if resp.status >= 300:
                    raise IOError(f"collector HTTP {resp.status}")
            finally:
                conn.close()
            return
        from seaweedfs_tpu_torch.util.http_pool import shared_pool

        status, _body = shared_pool().request(
            f"{self.url.hostname}:{self.url.port or 80}", "POST", path,
            body=body, headers=headers, timeout=5,
        )
        if status >= 300:
            raise IOError(f"collector HTTP {status}")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if not self.master.is_leader:
                continue  # only the leader reports a cluster
            try:
                self._post(self.snapshot())
                self.sent += 1
            except Exception as e:  # noqa: BLE001 — telemetry must never hurt
                if wlog.V(1):
                    wlog.info("telemetry: post failed: %s", e)
                self.errors += 1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3)
