"""Master server: topology coordination over gRPC + HTTP.

The port's copy of the single-master half of
seaweedfs_tpu/server/master_server.py (reference
weed/server/master_server.go:62-87, master_grpc_server*.go): it receives
streaming heartbeats from volume servers (full state then deltas,
including EC shard bitsets and their storage class), serves ``Assign``,
``VolumeGrow``, ``LookupVolume``, ``LookupEcVolume``, ``VolumeList`` and
``CollectionList``, leases the shell's cluster-exclusive admin lock,
prunes nodes that stop heartbeating, signs per-fid write JWTs when it has
a key, and answers the HTTP endpoints ``/dir/assign``, ``/dir/lookup``
(volume holders, else EC shard holders) and ``/metrics`` on ``port``.  It
runs no kernel and takes no device.

Not ported: HA (raft, lease election, follower forwarding and the
sequence barrier: the one master always leads and its sequence is always
ready), the meta store, telemetry, ``/cluster/*`` and the cluster-node
registry.  Their RPCs answer UNIMPLEMENTED.
"""

from __future__ import annotations

import json
import os
import threading
import time
from urllib.parse import parse_qs, urlparse

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.security import sign_fid
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits
from seaweedfs_tpu_torch.topology.topology import DataNode, Topology, VolumeRecord
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler


def _to_record(v: m_pb.VolumeStat) -> VolumeRecord:
    return VolumeRecord(
        id=v.id,
        collection=v.collection,
        size=v.size,
        file_count=v.file_count,
        deleted_bytes=v.deleted_bytes,
        read_only=v.read_only,
        replica_placement=v.replica_placement or "000",
        version=v.version or 3,
        ttl_seconds=v.ttl_seconds,
        disk_type=v.disk_type or "hdd",
        last_scrub_ns=v.last_scrub_ns,
        scrub_corrupt=v.scrub_corrupt,
    )


def _to_ec_entry(e: m_pb.EcShardStat) -> tuple[int, str, ShardBits, int, int, int, str]:
    return (e.volume_id, e.collection, ShardBits(e.shard_bits), e.data_shards,
            e.parity_shards, e.local_groups, e.disk_type or "hdd")


def _location(node: DataNode) -> m_pb.Location:
    return m_pb.Location(url=node.url, public_url=node.public_url, grpc_port=node.grpc_port,
                         data_center=node.data_center)


class AdminLock:
    """Cluster-exclusive advisory lock leased to one shell client
    (reference: master-held lock behind LeaseAdminToken, shell/commands.go
    + wdclient/exclusive_locks)."""

    TTL = 10.0

    def __init__(self):
        self._lock = threading.Lock()
        self._holders: dict[str, tuple[int, float, str]] = {}

    def lease(self, lock_name: str, prev_token: int, client: str) -> tuple[int, int]:
        now = time.monotonic()
        with self._lock:
            held = self._holders.get(lock_name)
            if held is not None:
                token, ts, holder = held
                if now - ts < self.TTL and prev_token != token:
                    raise PermissionError(f"lock {lock_name} held by {holder}")
            token = prev_token if held and held[0] == prev_token else time.time_ns()
            self._holders[lock_name] = (token, now, client)
            return token, time.time_ns()

    def release(self, lock_name: str, token: int) -> None:
        with self._lock:
            held = self._holders.get(lock_name)
            if held and held[0] == token:
                del self._holders[lock_name]


class MasterGrpcServicer:
    def __init__(self, ms: "MasterServer"):
        self.ms = ms

    # -- streaming heartbeat ----------------------------------------------

    def send_heartbeat(self, request_iterator, context):
        topo = self.ms.topology
        node: DataNode | None = None
        for hb in request_iterator:
            if node is None:
                node = topo.register_node(DataNode(
                    node_id=f"{hb.ip}:{hb.port}",
                    ip=hb.ip,
                    port=hb.port,
                    grpc_port=hb.grpc_port,
                    public_url=hb.public_url,
                    data_center=hb.data_center or "DefaultDataCenter",
                    rack=hb.rack or "DefaultRack",
                    max_volume_count=int(hb.max_volume_count) or 8,
                ))
            node.last_seen = time.monotonic()
            if hb.max_volume_count:
                node.max_volume_count = int(hb.max_volume_count)
            if hb.max_volume_counts:
                node.max_volume_counts = {(t or "hdd"): int(c)
                                          for t, c in hb.max_volume_counts.items()}
            elif hb.max_volume_count and set(node.max_volume_counts) <= {"hdd"}:
                # legacy heartbeat without the per-type map: adopt the
                # total as hdd, but never clobber a known typed layout
                node.max_volume_counts = {"hdd": int(hb.max_volume_count)}
            if hb.volumes or hb.has_no_volumes:
                topo.sync_full_volumes(node, [_to_record(v) for v in hb.volumes])
            if hb.new_volumes or hb.deleted_volumes:
                topo.apply_volume_deltas(node, [_to_record(v) for v in hb.new_volumes],
                                         [_to_record(v) for v in hb.deleted_volumes])
            if hb.ec_shards or hb.has_no_ec_shards:
                topo.sync_full_ec_shards(node, [_to_ec_entry(e) for e in hb.ec_shards])
            if hb.new_ec_shards or hb.deleted_ec_shards:
                topo.apply_ec_deltas(node, [_to_ec_entry(e) for e in hb.new_ec_shards],
                                     [_to_ec_entry(e) for e in hb.deleted_ec_shards])
            yield m_pb.HeartbeatResponse(volume_size_limit=topo.volume_size_limit,
                                         leader=self.ms.grpc_address)

    # -- unary RPCs --------------------------------------------------------

    def assign(self, request, context):
        try:
            fid, nodes = self.ms.topology.pick_for_write(
                max(1, request.count), request.collection,
                request.replication or self.ms.default_replication, request.ttl_seconds,
                disk_type=request.disk_type, growth_count=max(1, request.writable_volume_count))
        except Exception as e:  # noqa: BLE001 — surfaced as the response's error
            return m_pb.AssignResponse(error=str(e))
        stats.MASTER_REQUESTS.inc(type="assign")
        return m_pb.AssignResponse(fid=fid, count=max(1, request.count),
                                   location=_location(nodes[0]),
                                   replicas=[_location(n) for n in nodes[1:]],
                                   auth=self.ms.sign_write_jwt(fid))

    def volume_grow(self, request, context):
        """Pre-grow volumes for a layout (reference shell volume.grow ->
        master VolumeGrow; topology/volume_growth.go)."""
        vids = [self.ms.topology.grow_volumes(
                    request.collection, request.replication or self.ms.default_replication,
                    request.ttl_seconds, disk_type=request.disk_type)
                for _ in range(max(1, request.count))]
        return m_pb.VolumeGrowResponse(volume_ids=vids)

    def lookup_volume(self, request, context):
        out = []
        for vof in request.volume_or_file_ids:
            vid_str = vof.split(",")[0]
            try:
                vid = int(vid_str)
            except ValueError:
                out.append(m_pb.VolumeIdLocation(volume_or_file_id=vof,
                                                 error=f"bad volume id {vid_str}"))
                continue
            nodes = self.ms.topology.lookup(vid)
            if not nodes:
                # EC volumes answer lookups too (the read path probes both)
                shard_nodes = {n.id: n for nodes_ in self.ms.topology.lookup_ec_shards(vid).values()
                               for n in nodes_}
                nodes = list(shard_nodes.values())
            out.append(m_pb.VolumeIdLocation(
                volume_or_file_id=vof,
                locations=[_location(n) for n in nodes],
                error="" if nodes else f"volume {vid} not found",
            ))
        return m_pb.LookupVolumeResponse(volume_id_locations=out)

    def lookup_ec_volume(self, request, context):
        shard_locs = self.ms.topology.lookup_ec_shards(request.volume_id)
        return m_pb.LookupEcVolumeResponse(
            volume_id=request.volume_id,
            shard_id_locations=[
                m_pb.EcShardIdLocation(shard_id=sid, locations=[_location(n) for n in nodes])
                for sid, nodes in sorted(shard_locs.items())
            ],
        )

    def volume_list(self, request, context):
        topo = self.ms.topology
        with topo.lock:
            dcs: dict[str, dict[str, list[DataNode]]] = {}
            for node in topo.nodes.values():
                dcs.setdefault(node.data_center, {}).setdefault(node.rack, []).append(node)
            dc_infos = []
            for dc, racks in sorted(dcs.items()):
                rack_infos = []
                for rack, nodes in sorted(racks.items()):
                    dn_infos = [self._data_node_info(topo, n) for n in sorted(nodes, key=lambda x: x.id)]
                    rack_infos.append(m_pb.RackInfo(id=rack, data_node_infos=dn_infos))
                dc_infos.append(m_pb.DataCenterInfo(id=dc, rack_infos=rack_infos))
        return m_pb.VolumeListResponse(
            topology_info=m_pb.TopologyInfo(id="topo", data_center_infos=dc_infos),
            volume_size_limit_mb=topo.volume_size_limit // (1024 * 1024),
        )

    @staticmethod
    def _data_node_info(topo: Topology, n: DataNode) -> m_pb.DataNodeInfo:
        # one DiskInfo per disk type present on the node
        types = (set(n.max_volume_counts) | {r.disk_type for r in n.volumes.values()}
                 | set(n.ec_disk_types.values())) or {"hdd"}
        # each EC volume's shards report on the row of the disk that holds
        # them (heartbeat disk_type), defaulting to the hdd row
        ec_row = "hdd" if "hdd" in types else sorted(types)[0]
        disk_infos = {}
        for dt in sorted(types):
            vols = [r for r in n.volumes.values() if r.disk_type == dt]
            disk_infos[dt] = m_pb.DiskInfo(
                type=dt,
                volume_count=len(vols),
                max_volume_count=n.max_volume_counts.get(dt, 0),
                free_volume_count=max(0, n.free_slots(dt)),
                volume_infos=[
                    m_pb.VolumeStat(
                        id=r.id, collection=r.collection, size=r.size, file_count=r.file_count,
                        deleted_bytes=r.deleted_bytes, read_only=r.read_only,
                        replica_placement=r.replica_placement, version=r.version,
                        ttl_seconds=r.ttl_seconds, disk_type=dt, last_scrub_ns=r.last_scrub_ns,
                        scrub_corrupt=r.scrub_corrupt,
                    )
                    for r in vols
                ],
                ec_shard_infos=[
                    m_pb.EcShardStat(
                        volume_id=vid,
                        collection=n.ec_collections.get(vid, ""),
                        shard_bits=int(bits),
                        data_shards=topo.ec_schemes.get(vid, (0, 0, 0))[0],
                        parity_shards=topo.ec_schemes.get(vid, (0, 0, 0))[1],
                        local_groups=topo.ec_schemes.get(vid, (0, 0, 0))[2],
                        disk_type=dt,
                    )
                    for vid, bits in n.ec_shards.items()
                    if n.ec_disk_types.get(vid, ec_row) == dt
                ],
            )
        return m_pb.DataNodeInfo(id=n.id, url=n.url, public_url=n.public_url,
                                 grpc_port=n.grpc_port, disk_infos=disk_infos)

    def collection_list(self, request, context):
        return m_pb.CollectionListResponse(
            collections=[m_pb.Collection(name=c) for c in sorted(self.ms.topology.collections())
                         if c])

    def lease_admin_token(self, request, context):
        try:
            token, ts = self.ms.admin_lock.lease(request.lock_name, request.previous_token,
                                                 request.client_name)
        except PermissionError as e:
            context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        return m_pb.LeaseAdminTokenResponse(token=token, lock_ts_ns=ts)

    def release_admin_token(self, request, context):
        self.ms.admin_lock.release(request.lock_name, request.previous_token)
        return m_pb.ReleaseAdminTokenResponse()


class _MasterHttpHandler(QuietHandler):
    ms: "MasterServer" = None  # class attribute injected per server

    def _json(self, obj, code: int = 200) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        if url.path == "/metrics":
            self._reply(200, stats.render_text().encode(), "text/plain; version=0.0.4")
        elif url.path == "/dir/assign":
            try:
                fid, nodes = self.ms.topology.pick_for_write(
                    int(q.get("count", ["1"])[0]), q.get("collection", [""])[0],
                    q.get("replication", [self.ms.default_replication])[0],
                    int(q.get("ttl", ["0"])[0] or 0), disk_type=q.get("disk", [""])[0])
            except Exception as e:  # noqa: BLE001 — the client gets the reason
                self._json({"error": str(e)}, 500)
                return
            out = {"fid": fid, "url": nodes[0].url, "publicUrl": nodes[0].public_url, "count": 1}
            auth = self.ms.sign_write_jwt(fid)
            if auth:
                out["auth"] = auth
            self._json(out)
        elif url.path == "/dir/lookup":
            vid = q.get("volumeId", [""])[0].split(",")[0]
            nodes = self.ms.topology.lookup(int(vid)) if vid.isdigit() else []
            if not nodes and vid.isdigit():
                shard_nodes = {n.id: n for ns in self.ms.topology.lookup_ec_shards(int(vid)).values()
                               for n in ns}
                nodes = list(shard_nodes.values())
            if nodes:
                self._json({"volumeId": vid, "locations": [
                    {"url": n.url, "publicUrl": n.public_url} for n in nodes]})
            else:
                self._json({"volumeId": vid, "error": "not found"}, 404)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        self._drain()
        self.do_GET()


class MasterServer:
    """One master: the topology, the admin lock, the gRPC and HTTP servers
    and the dead-node prune loop."""

    def __init__(
        self,
        ip: str = "127.0.0.1",
        port: int = 9333,
        grpc_port: int = 0,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        jwt_key: str = "",
    ):
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port if (grpc_port or port == 0) else port + 10000
        self.topology = Topology(volume_size_limit_mb * 1024 * 1024)
        self.admin_lock = AdminLock()
        self.default_replication = default_replication
        self.jwt_key = jwt_key or os.environ.get("WEED_JWT_KEY", "")
        self._grpc_server = None
        self._http_server = None
        self._stop = threading.Event()

    @property
    def advertise(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def sign_write_jwt(self, fid: str) -> str:
        """Per-fid write token when the cluster signs writes (reference
        security.GenJwtForVolumeServer); empty string when disabled."""
        if not self.jwt_key:
            return ""
        return sign_fid(self.jwt_key, fid)

    def _prune_loop(self) -> None:
        while not self._stop.wait(self.topology.dead_node_timeout / 3):
            self.topology.prune_dead_nodes()

    def start(self) -> None:
        self._grpc_server = rpc.make_server()
        rpc.add_service(self._grpc_server, m_pb, "Master", MasterGrpcServicer(self))
        self.grpc_port = rpc.add_port(self._grpc_server, f"{self.ip}:{self.grpc_port}")
        self._grpc_server.start()
        handler = type("Handler", (_MasterHttpHandler,), {"ms": self})
        self._http_server = PooledHTTPServer((self.ip, self.port), handler)
        self.port = self._http_server.server_address[1]
        threading.Thread(target=self._http_server.serve_forever, daemon=True).start()
        threading.Thread(target=self._prune_loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server is not None:
            # wait for termination: a mid-grace return leaves the port
            # half-dead (client RPCs get CANCELLED, not UNAVAILABLE)
            self._grpc_server.stop(grace=0.5).wait()
