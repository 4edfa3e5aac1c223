"""Generic typed node registry (reference weed/cluster/cluster.go): the
port's copy of seaweedfs_tpu/cluster/registry.py.

Filers, message-queue brokers, and other non-volume components announce
themselves to the master by type; clients discover them via
/cluster/nodes.  Liveness is TTL-based: a node that stops re-registering
ages out.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class ClusterNode:
    node_type: str  # "filer" | "broker" | ...
    address: str
    data_center: str = ""
    rack: str = ""
    version: str = ""
    created_at: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.time)
    # freshness clock for TTL pruning: last_seen stays wall-clock for
    # display, but expiry must not jump when the wall clock steps
    seen_mono: float = field(default_factory=time.monotonic)

    def to_json(self) -> dict:
        return {
            "type": self.node_type,
            "address": self.address,
            "data_center": self.data_center,
            "rack": self.rack,
            "version": self.version,
            "created_at": self.created_at,
            "last_seen": self.last_seen,
        }


class ClusterRegistry:
    def __init__(self, ttl: float = 15.0):
        self.ttl = ttl
        self._lock = threading.Lock()
        self._nodes: dict[tuple[str, str], ClusterNode] = {}

    def register(
        self,
        node_type: str,
        address: str,
        data_center: str = "",
        rack: str = "",
        version: str = "",
    ) -> ClusterNode:
        with self._lock:
            key = (node_type, address)
            node = self._nodes.get(key)
            if node is None:
                node = ClusterNode(node_type, address, data_center, rack, version)
                self._nodes[key] = node
            node.last_seen = time.time()
            node.seen_mono = time.monotonic()
            if data_center:
                node.data_center = data_center
            if rack:
                node.rack = rack
            if version:
                node.version = version
            return node

    def unregister(self, node_type: str, address: str) -> None:
        with self._lock:
            self._nodes.pop((node_type, address), None)

    def list(self, node_type: str = "") -> list[ClusterNode]:
        cutoff = time.monotonic() - self.ttl
        with self._lock:
            self._prune(cutoff)
            return sorted(
                (
                    n
                    for n in self._nodes.values()
                    if not node_type or n.node_type == node_type
                ),
                key=lambda n: (n.node_type, n.address),
            )

    def _prune(self, cutoff: float) -> None:
        for key in [k for k, n in self._nodes.items() if n.seen_mono < cutoff]:
            del self._nodes[key]
