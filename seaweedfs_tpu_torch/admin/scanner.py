"""Maintenance scanner: detect volumes needing EC-encode or vacuum; the
port's copy of seaweedfs_tpu/admin/scanner.py.

Counterpart of the reference's MaintenanceScanner.ScanForMaintenanceTasks
(weed/admin/maintenance/maintenance_scanner.go:34) with
the detection rules from its DESIGN.md: EC-encode when a volume is at
least `ec_full_percent`% of the size limit and has been write-quiet for
`ec_quiet_seconds`; vacuum when the garbage ratio (deleted bytes / size)
exceeds `vacuum_garbage_ratio`.  Detection reads the same VolumeList
topology the shell uses; quiet-ness asks the holding volume server for
last-modified (the shell's collectVolumeIdsForEcEncode does the same).
EC shards missing on two consecutive scans become EC_REBUILD tasks, and
a TTL volume every holder reports older than its TTL a TTL_DELETE task.
The scanner runs no kernel: the encode and the rebuild it schedules run
in the volume servers.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.admin import tasks as T
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.shell.ec_common import grpc_addr
from seaweedfs_tpu_torch.util import wlog


@dataclass(frozen=True)
class MaintenancePolicy:
    ec_full_percent: float = 95.0
    ec_quiet_seconds: float = 3600.0
    vacuum_garbage_ratio: float = 0.3
    scan_interval: float = 30.0
    enable_ec: bool = True
    enable_vacuum: bool = True
    enable_ttl_delete: bool = True
    # repair EC volumes with missing shards (EC_REBUILD tasks); the
    # rebuild itself self-limits under WEED_REPAIR_RATE_MB server-side
    enable_ec_rebuild: bool = True


class MaintenanceScanner:
    def __init__(
        self,
        master_grpc_address: str,
        queue: T.TaskQueue,
        policy: MaintenancePolicy = MaintenancePolicy(),
    ):
        self.master_address = master_grpc_address
        self.queue = queue
        self.policy = policy
        self._master: rpc.Stub | None = None
        self._volumes: dict[str, rpc.Stub] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # vids that looked shard-degraded on the PREVIOUS scan (EC
        # rebuild needs two consecutive sightings before acting)
        self._ec_degraded_seen: set[int] = set()

    # ---- stubs ----------------------------------------------------------
    @property
    def master(self) -> rpc.Stub:
        if self._master is None:
            self._master = rpc.master_stub(self.master_address)
        return self._master

    def volume(self, grpc_address: str) -> rpc.Stub:
        if grpc_address not in self._volumes:
            self._volumes[grpc_address] = rpc.volume_stub(grpc_address)
        return self._volumes[grpc_address]

    # ---- one scan -------------------------------------------------------
    def scan_once(self) -> list[T.Task]:
        """Detect and enqueue; returns newly created tasks."""
        resp = self.master.VolumeList(m_pb.VolumeListRequest())
        limit = resp.volume_size_limit_mb * 1024 * 1024
        created: list[T.Task] = []
        ec_vids = set()
        # EC shard census: union of held shards + the scheme's total, so
        # the scanner spots volumes running degraded (missing shards)
        ec_present: dict[int, int] = {}
        ec_total: dict[int, int] = {}
        ec_collection: dict[int, str] = {}
        writable: dict[int, m_pb.VolumeStat] = {}
        holders: dict[int, list[m_pb.DataNodeInfo]] = {}
        for dc in resp.topology_info.data_center_infos:
            for rack in dc.rack_infos:
                for dn in rack.data_node_infos:
                    for disk in dn.disk_infos.values():
                        for es in disk.ec_shard_infos:
                            ec_vids.add(es.volume_id)
                            ec_present[es.volume_id] = (
                                ec_present.get(es.volume_id, 0)
                                | es.shard_bits
                            )
                            if es.data_shards:
                                ec_total[es.volume_id] = (
                                    es.data_shards + es.parity_shards
                                )
                            ec_collection[es.volume_id] = es.collection
                        for v in disk.volume_infos:
                            writable[v.id] = v
                            holders.setdefault(v.id, []).append(dn)

        if self.policy.enable_ec_rebuild:
            degraded_now = set()
            for vid, bits in sorted(ec_present.items()):
                total = ec_total.get(vid, 14)  # default RS(10,4)/LRC(10,2,2)
                held = bits.bit_count()
                if not 0 < held < total:
                    continue
                degraded_now.add(vid)
                # don't fight a concurrent encode: its shards mount
                # incrementally and a partial census looks degraded
                if self.queue.has_active(T.EC_ENCODE, vid):
                    continue
                # stability window: the volume must look degraded on two
                # CONSECUTIVE scans — one heartbeat-lagged snapshot
                # mid-mount/balance is not a lost shard
                if vid not in self._ec_degraded_seen:
                    continue
                t = self.queue.submit(
                    T.EC_REBUILD, vid, ec_collection.get(vid, "")
                )
                if t:
                    created.append(t)
            self._ec_degraded_seen = degraded_now

        now_ns = time.time_ns()
        for vid, v in sorted(writable.items()):
            if vid in ec_vids:
                continue  # already erasure-coded
            if self.policy.enable_ttl_delete and v.ttl_seconds > 0:
                # a TTL volume whose last write is older than its TTL
                # holds only expired needles: reclaim the whole volume
                # (reference topology_vacuum.go TTL volume expiry)
                if self._all_expired(
                    holders.get(vid, []), vid, v.ttl_seconds, now_ns
                ):
                    t = self.queue.submit(
                        T.TTL_DELETE, vid, v.collection,
                        ttl_seconds=v.ttl_seconds,
                    )
                    if t:
                        created.append(t)
                    continue
                # not expired: still vacuum-eligible (a long-TTL volume
                # must not accumulate garbage for a year), but never EC
                if self.policy.enable_vacuum and v.size > 0:
                    ratio = v.deleted_bytes / v.size
                    if ratio > self.policy.vacuum_garbage_ratio:
                        t = self.queue.submit(
                            T.VACUUM, vid, v.collection,
                            garbage_threshold=self.policy.vacuum_garbage_ratio,
                        )
                        if t:
                            created.append(t)
                continue
            if self.policy.enable_vacuum and v.size > 0:
                ratio = v.deleted_bytes / v.size
                if ratio > self.policy.vacuum_garbage_ratio:
                    t = self.queue.submit(
                        T.VACUUM,
                        vid,
                        v.collection,
                        garbage_threshold=self.policy.vacuum_garbage_ratio,
                    )
                    if t:
                        created.append(t)
                    continue  # vacuum first; EC-encode a compacted volume
            if not self.policy.enable_ec or limit <= 0:
                continue
            if v.size < limit * self.policy.ec_full_percent / 100.0:
                continue
            if self.policy.ec_quiet_seconds > 0 and not self._is_quiet(
                holders.get(vid, []), vid, now_ns
            ):
                continue
            t = self.queue.submit(T.EC_ENCODE, vid, v.collection)
            if t:
                created.append(t)
        return created

    def _all_expired(
        self,
        nodes: list[m_pb.DataNodeInfo],
        vid: int,
        ttl_seconds: int,
        now_ns: int,
    ) -> bool:
        if not nodes:
            return False
        for dn in nodes:
            try:
                st = self.volume(grpc_addr(dn.url, dn.grpc_port)).VolumeStatus(
                    vs_pb.VolumeStatusRequest(volume_id=vid)
                )
            except Exception as e:  # noqa: BLE001 — unreachable: don't delete blind
                if wlog.V(1):
                    wlog.info("scanner: status vid=%d unreachable: %s", vid, e)
                return False
            if not st.last_modified_ns:
                # age unknown (never-written or pre-mtime-restore volume):
                # NEVER reclaim on a missing clock — deleting live data is
                # the one unrecoverable mistake this scanner can make
                return False
            if now_ns - st.last_modified_ns < ttl_seconds * 1_000_000_000:
                return False
        return True

    def _is_quiet(
        self, nodes: list[m_pb.DataNodeInfo], vid: int, now_ns: int
    ) -> bool:
        for dn in nodes:
            try:
                st = self.volume(grpc_addr(dn.url, dn.grpc_port)).VolumeStatus(
                    vs_pb.VolumeStatusRequest(volume_id=vid)
                )
            except Exception as e:
                if wlog.V(1):
                    wlog.info("scanner: status vid=%d unreachable: %s", vid, e)
                return False  # unreachable holder: don't encode blind
            if (
                st.last_modified_ns
                and now_ns - st.last_modified_ns
                < self.policy.ec_quiet_seconds * 1e9
            ):
                return False
        return True

    # ---- loop -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="maintenance-scanner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.scan_interval):
            try:
                self.scan_once()
            except Exception as e:
                wlog.warning("scanner: scan pass failed: %s", e)  # next tick retries
