"""Master server: topology coordination over gRPC + HTTP.

The port's copy of seaweedfs_tpu/server/master_server.py (reference
weed/server/master_server.go:62-87, master_grpc_server*.go,
raft_server.go, raft_hashicorp.go): it receives streaming heartbeats from
volume servers (full state then deltas, including EC shard bitsets and
their storage class), serves ``Assign``, ``VolumeGrow``, ``LookupVolume``,
``LookupEcVolume``, ``VolumeList``, ``Statistics``, ``CollectionList``,
``CollectionDelete``, ``ListClusterNodes`` and the ``Raft*`` admin RPCs,
leases the shell's cluster-exclusive admin lock, prunes nodes that stop
heartbeating, signs per-fid write JWTs when it has a key, and answers the
HTTP endpoints ``/dir/assign``, ``/dir/lookup``, ``/cluster/*``,
``/raft/*`` and ``/metrics`` on ``port``.  It runs no kernel and takes no
device.

HA: masters given ``peers`` elect a leader, by lease probes (``ha="lease"``,
cluster/election.py) or by raft (``ha="raft"``, cluster/raft.py, which
needs ``meta_dir``; an empty peer list is a passive joiner).  Followers
forward unary RPCs to the leader with its status code, redirect the
heartbeat stream (``leader`` in HeartbeatResponse) and HTTP ``/dir/*``
(307) to it.  Sequence state (max volume id, file-key hi-lo ceiling)
persists in ``meta_dir`` (``master.meta.json``) and, under raft, rides the
log; a new raft leader jumps both watermarks past anything its
predecessor could have issued and serves assigns and growth only once
that jump has committed (the sequence barrier).  Unlike the JAX master, a
leader does not re-apply its own committed watermarks (``_raft_apply``).

Not ported: the telemetry collector (``-telemetryUrl``).
"""

from __future__ import annotations

import functools
import hmac
import json
import os
import threading
import time
import uuid
from urllib.parse import parse_qs, urlparse

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.cluster import ClusterRegistry, LeaderElection
from seaweedfs_tpu_torch.cluster.raft import HttpRaftTransport, RaftNode, raft_token
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.security import sign_fid
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits
from seaweedfs_tpu_torch.topology.topology import DataNode, Topology, VolumeRecord
from seaweedfs_tpu_torch.util import resilience, wlog
from seaweedfs_tpu_torch.util.httpd import PooledHTTPServer, QuietHandler

SEQUENCE_BARRIER = "leader takeover in progress (sequence barrier)"


class MasterMetaStore:
    """Durable sequence state: atomically persisted JSON in meta_dir.

    File keys use hi-lo: the stored ceiling (Topology.FILE_KEY_MARGIN
    ahead of any key handed out) is what persists, so saving every margin
    step, not every assign, still guarantees monotonic ids across
    restarts."""

    def __init__(self, meta_dir: str):
        os.makedirs(meta_dir, exist_ok=True)
        self.path = os.path.join(meta_dir, "master.meta.json")

    def load(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def save(self, max_volume_id: int, file_key_ceiling: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"max_volume_id": max_volume_id, "file_key_ceiling": file_key_ceiling}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


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


def _leader_only(fn):
    """Follower masters forward unary RPCs to the leader so any master
    address serves clients (the reference redirects via Raft leader
    info).  Resolved per call: leadership changes at runtime."""

    camel = "".join(p.capitalize() for p in fn.__name__.split("_"))

    @functools.wraps(fn)
    def wrapper(self, request, context):
        ms = self.ms
        leader = ms.leader_grpc
        # serve locally when leader, and also when the "leader" resolves to
        # our own gRPC address under a different spelling: forwarding to
        # self would recurse until the server's thread pool deadlocks
        if ms.is_leader or leader == ms.grpc_address:
            return fn(self, request, context)
        try:
            return getattr(rpc.master_stub(leader), camel)(
                request, timeout=resilience.policy().deadline_s)
        except grpc.RpcError as e:
            if e.code() is grpc.StatusCode.UNAVAILABLE:
                rpc.evict_channel(leader)
            # surface the leader's status code and details, not UNKNOWN
            context.abort(e.code(), e.details() or str(e))

    return wrapper


class MasterGrpcServicer:
    def __init__(self, ms: "MasterServer"):
        self.ms = ms

    # -- streaming heartbeat ----------------------------------------------

    def send_heartbeat(self, request_iterator, context):
        topo = self.ms.topology
        node: DataNode | None = None
        for hb in request_iterator:
            if not self.ms.is_leader:
                # redirect: the volume server reconnects to the leader
                yield m_pb.HeartbeatResponse(volume_size_limit=topo.volume_size_limit,
                                             leader=self.ms.leader_grpc)
                return
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

    @_leader_only
    def assign(self, request, context):
        if not self.ms.sequence_ready():
            return m_pb.AssignResponse(error=SEQUENCE_BARRIER)
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

    @_leader_only
    def volume_grow(self, request, context):
        """Pre-grow volumes for a layout (reference shell volume.grow ->
        master VolumeGrow; topology/volume_growth.go)."""
        if not self.ms.sequence_ready():
            context.abort(grpc.StatusCode.UNAVAILABLE, SEQUENCE_BARRIER)
        vids = [self.ms.topology.grow_volumes(
                    request.collection, request.replication or self.ms.default_replication,
                    request.ttl_seconds, disk_type=request.disk_type)
                for _ in range(max(1, request.count))]
        return m_pb.VolumeGrowResponse(volume_ids=vids)

    @_leader_only
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

    @_leader_only
    def lookup_ec_volume(self, request, context):
        shard_locs = self.ms.topology.lookup_ec_shards(request.volume_id)
        return m_pb.LookupEcVolumeResponse(
            volume_id=request.volume_id,
            shard_id_locations=[
                m_pb.EcShardIdLocation(shard_id=sid, locations=[_location(n) for n in nodes])
                for sid, nodes in sorted(shard_locs.items())
            ],
        )

    @_leader_only
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

    @_leader_only
    def statistics(self, request, context):
        topo = self.ms.topology
        with topo.lock:
            total = sum(n.max_volume_count * topo.volume_size_limit for n in topo.nodes.values())
            used = sum(r.size for n in topo.nodes.values() for r in n.volumes.values())
            files = sum(r.file_count for n in topo.nodes.values() for r in n.volumes.values())
        return m_pb.StatisticsResponse(total_size=total, used_size=used, file_count=files)

    @_leader_only
    def collection_list(self, request, context):
        return m_pb.CollectionListResponse(
            collections=[m_pb.Collection(name=c) for c in sorted(self.ms.topology.collections())
                         if c])

    @_leader_only
    def collection_delete(self, request, context):
        # volume deletion fans out from the shell; the master just forgets
        return m_pb.CollectionDeleteResponse()

    @_leader_only
    def lease_admin_token(self, request, context):
        try:
            token, ts = self.ms.admin_lock.lease(request.lock_name, request.previous_token,
                                                 request.client_name)
        except PermissionError as e:
            context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        return m_pb.LeaseAdminTokenResponse(token=token, lock_ts_ns=ts)

    @_leader_only
    def release_admin_token(self, request, context):
        self.ms.admin_lock.release(request.lock_name, request.previous_token)
        return m_pb.ReleaseAdminTokenResponse()

    @_leader_only
    def list_cluster_nodes(self, request, context):
        """Typed node registry for shell/client discovery (reference
        master_grpc_server_cluster.go ListClusterNodes)."""
        return m_pb.ListClusterNodesResponse(nodes=[
            m_pb.ClusterNodeInfo(address=n.address, node_type=n.node_type,
                                 data_center=n.data_center, rack=n.rack, version=n.version)
            for n in self.ms.registry.list(request.node_type)
        ])

    # -- raft administration (reference master.proto Raft* RPCs) ----------

    def _require_raft(self, context):
        if self.ms.raft is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "this master does not run -ha raft")
        return self.ms.raft

    def raft_list_cluster_servers(self, request, context):
        st = self._require_raft(context).status()
        return m_pb.RaftListClusterServersResponse(
            leader=st["leader"],
            term=st["term"],
            commit_index=st["commit_index"],
            last_index=st["last_index"],
            servers=[m_pb.RaftServerInfo(id=m, is_leader=(m == st["leader"]),
                                         match_index=st["match_index"].get(m, 0))
                     for m in st["members"]],
        )

    @_leader_only
    def raft_add_server(self, request, context):
        raft = self._require_raft(context)
        ok = raft.add_member(request.id)
        return m_pb.RaftAddServerResponse(ok=ok, members=raft.status()["members"])

    @_leader_only
    def raft_remove_server(self, request, context):
        raft = self._require_raft(context)
        ok = raft.remove_member(request.id)
        return m_pb.RaftRemoveServerResponse(ok=ok, members=raft.status()["members"])


class _MasterHttpHandler(QuietHandler):
    ms: "MasterServer" = None  # class attribute injected per server

    def _json(self, obj, code: int = 200) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _redirect_to_leader(self) -> None:
        self.send_response(307)
        self.send_header("Location", f"http://{self.ms.leader_http}{self.path}")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        ms = self.ms
        url = urlparse(self.path)
        q = parse_qs(url.query)
        if url.path == "/metrics":
            self._reply(200, stats.render_text().encode(), "text/plain; version=0.0.4")
        elif url.path == "/cluster/ping":
            # liveness probe for leader election: identity + current view +
            # sequence watermarks (peers adopt them; see restore_sequence)
            max_vid, key_ceiling = ms.topology.sequence_watermarks()
            self._json({"address": ms.advertise, "grpc_address": ms.grpc_address,
                        "leader": ms.leader_http, "max_volume_id": max_vid,
                        "file_key_ceiling": key_ceiling})
        elif url.path == "/cluster/raft/ps":
            if ms.raft is None:
                self._json({"error": "raft not enabled"}, 400)
            else:
                self._json(ms.raft.status())
        elif url.path in ("/cluster/raft/add", "/cluster/raft/remove"):
            if ms.raft is None:
                self._json({"error": "raft not enabled"}, 400)
            elif not ms.is_leader and ms.leader_http != ms.advertise:
                self._redirect_to_leader()
            elif not q.get("address", [""])[0]:
                self._json({"error": "address required"}, 400)
            else:
                op = ms.raft.add_member if url.path.endswith("add") else ms.raft.remove_member
                ok = op(q["address"][0])
                self._json({"ok": ok, "members": ms.raft.status()["members"]}, 200 if ok else 500)
        elif (url.path in ("/cluster/nodes", "/cluster/register") and not ms.is_leader
              and ms.leader_http != ms.advertise):
            # the registry lives on the leader; any master address works
            self._redirect_to_leader()
        elif url.path == "/cluster/nodes":
            node_type = q.get("type", [""])[0]
            self._json({"nodes": [n.to_json() for n in ms.registry.list(node_type)]})
        elif url.path == "/cluster/register":
            node_type, address = q.get("type", [""])[0], q.get("address", [""])[0]
            if not node_type or not address:
                self._json({"error": "type and address required"}, 400)
                return
            ms.registry.register(node_type, address, data_center=q.get("dataCenter", [""])[0],
                                 rack=q.get("rack", [""])[0], version=q.get("version", [""])[0])
            self._json({"ok": True})
        elif url.path.startswith("/dir/") and not ms.is_leader:
            # follower: send HTTP clients to the leader
            self._redirect_to_leader()
        elif url.path == "/dir/assign":
            if not ms.sequence_ready():
                self._json({"error": SEQUENCE_BARRIER}, 503)
                return
            try:
                fid, nodes = ms.topology.pick_for_write(
                    int(q.get("count", ["1"])[0]), q.get("collection", [""])[0],
                    q.get("replication", [ms.default_replication])[0],
                    int(q.get("ttl", ["0"])[0] or 0), disk_type=q.get("disk", [""])[0])
            except Exception as e:  # noqa: BLE001 — the client gets the reason
                self._json({"error": str(e)}, 500)
                return
            out = {"fid": fid, "url": nodes[0].url, "publicUrl": nodes[0].public_url, "count": 1}
            auth = ms.sign_write_jwt(fid)
            if auth:
                out["auth"] = auth
            self._json(out)
        elif url.path == "/dir/lookup":
            vid = q.get("volumeId", [""])[0].split(",")[0]
            nodes = ms.topology.lookup(int(vid)) if vid.isdigit() else []
            if not nodes and vid.isdigit():
                shard_nodes = {n.id: n for ns in ms.topology.lookup_ec_shards(int(vid)).values()
                               for n in ns}
                nodes = list(shard_nodes.values())
            if nodes:
                self._json({"volumeId": vid, "locations": [
                    {"url": n.url, "publicUrl": n.public_url} for n in nodes]})
            else:
                self._json({"volumeId": vid, "error": "not found"}, 404)
        elif url.path == "/cluster/status":
            peers = (ms.raft.status()["members"] if ms.raft is not None
                     else sorted(ms.election.alive() if ms.election else {}))
            self._json({"IsLeader": ms.is_leader, "Leader": ms.leader_http, "Peers": peers,
                        "MaxVolumeId": ms.topology.max_volume_id})
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        url = urlparse(self.path)
        if not (url.path.startswith("/raft/") and self.ms.raft is not None):
            self._drain()
            self.do_GET()
            return
        # raft rides the client-facing port: with a cluster secret, peers
        # must present the derived token, or anyone who can reach
        # /dir/assign could install snapshots or inflate terms
        if self.ms.raft_rpc_token:
            got = self.headers.get("X-Raft-Token", "")
            if not hmac.compare_digest(got, self.ms.raft_rpc_token):
                self._drain()
                self._json({"error": "raft rpc unauthorized"}, 403)
                return
        length = int(self.headers.get("Content-Length", "0") or 0)
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self._json({"error": "bad json"}, 400)
            return
        self._json(self.ms.raft.handle_rpc(url.path[len("/raft/"):], payload))


class MasterServer:
    """One master: the topology, the admin lock, the node registry, the
    gRPC and HTTP servers, the dead-node prune loop and, with ``peers`` or
    ``ha="raft"``, the leader election (module docstring)."""

    def __init__(
        self,
        ip: str = "127.0.0.1",
        port: int = 9333,
        grpc_port: int = 0,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        peers: list[str] | None = None,
        meta_dir: str = "",
        ha: str = "lease",
        election_interval: float = 1.0,
        jwt_key: str = "",
    ):
        self.ip = ip
        self.port = port
        self.grpc_port = grpc_port if (grpc_port or port == 0) else port + 10000
        self.topology = Topology(volume_size_limit_mb * 1024 * 1024)
        self.admin_lock = AdminLock()
        self.default_replication = default_replication
        self.registry = ClusterRegistry()
        self.meta_store = MasterMetaStore(meta_dir) if meta_dir else None
        if self.meta_store:
            meta = self.meta_store.load()
            self.topology.restore_sequence(int(meta.get("max_volume_id", 0)),
                                           int(meta.get("file_key_ceiling", 0)))
            self.topology.persist = self.meta_store.save
        self._peers = peers or []
        self._election_interval = election_interval
        self.jwt_key = jwt_key or os.environ.get("WEED_JWT_KEY", "")
        # derived once: the /raft/* handler compares it per heartbeat
        self.raft_rpc_token = raft_token(self.jwt_key) if self.jwt_key else ""
        self.election: LeaderElection | None = None  # built in start()
        self.ha = ha
        self.raft: RaftNode | None = None  # built in start() when ha == "raft"
        if ha == "raft" and not meta_dir:
            raise ValueError("ha='raft' requires a meta_dir for the raft log")
        self._grpc_server = None
        self._http_server = None
        self._stop = threading.Event()

    def _durable_cluster_id(self) -> str:
        """One id per cluster, surviving restarts and failover: stored
        beside the master meta state (``cluster.id``) when a meta_dir
        exists."""
        if self.meta_store is None:
            return ""
        path = os.path.join(os.path.dirname(self.meta_store.path), "cluster.id")
        try:
            with open(path) as f:
                return f.read().strip()
        except FileNotFoundError:
            cid = uuid.uuid4().hex
            with open(path, "w") as f:
                f.write(cid)
            return cid

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

    # ---- leadership ------------------------------------------------------

    @property
    def is_leader(self) -> bool:
        if self.raft is not None:
            return self.raft.is_leader
        return self.election is None or self.election.is_leader

    def sequence_ready(self, timeout: float = 2.0) -> bool:
        """Gate for the id-issuing paths (assign, volume growth) after a
        raft takeover: the post-election watermark jump must commit before
        new fids or volume ids go out, or a leader that crashed mid-jump
        would let its successor jump from a stale ceiling and reissue ids.
        Kept out of ``is_leader`` deliberately: heartbeats, redirects and
        status must not stall behind the barrier."""
        if self.raft is None:
            return True
        return self._seq_committed.wait(timeout)

    @property
    def leader_grpc(self) -> str:
        if self.raft is not None:
            if self.raft.is_leader:
                return self.grpc_address
            return self.raft.leader_meta.get("grpc") or self.grpc_address
        return self.election.leader_grpc if self.election else self.grpc_address

    @property
    def leader_http(self) -> str:
        if self.raft is not None:
            if self.raft.is_leader:
                return self.advertise
            return self.raft.leader_id or self.advertise
        return self.election.leader_http if self.election else self.advertise

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
        if self.ha == "raft":
            self._start_raft()
        else:
            self.election = LeaderElection(self.advertise, self.grpc_address, self._peers,
                                           interval=self._election_interval,
                                           on_peer_state=self._adopt_peer_watermarks)
            self.election.start()

    def _start_raft(self) -> None:
        """Consensus-backed HA (reference raft_hashicorp.go): the log
        replicates sequence watermarks + membership; topology is rebuilt
        from heartbeats after failover, as the reference's snapshot does."""
        raft_dir = os.path.join(os.path.dirname(self.meta_store.path), "raft")
        self.raft = RaftNode(
            self.advertise,
            list(self._peers),  # empty peer list -> passive joiner
            raft_dir,
            HttpRaftTransport(secret=self.jwt_key),
            apply_fn=self._raft_apply,
            snapshot_fn=lambda: dict(zip(("max_volume_id", "file_key_ceiling"),
                                         self.topology.sequence_watermarks())),
            restore_fn=lambda st: self.topology.restore_sequence(
                int(st.get("max_volume_id", 0)), int(st.get("file_key_ceiling", 0))),
            meta={"grpc": self.grpc_address},
            heartbeat=max(0.05, self._election_interval / 3),
            election_timeout=(self._election_interval, self._election_interval * 2),
            on_leader=self._on_raft_leader,
        )
        # watermark updates happen under the topology lock; proposing
        # blocks on a majority, so hand the latest value to a background
        # proposer (latest-wins: watermarks are monotonic)
        self._seq_event = threading.Event()
        self._seq_latest = (0, 0)
        # takeover barrier: the id-issuing paths wait until the
        # post-election watermark jump has committed to the raft log
        self._seq_barrier = (0, 0)
        self._seq_barrier_armed = 0.0  # monotonic time of the last takeover
        self._seq_committed = threading.Event()
        self._seq_committed.set()  # follower state: no barrier pending
        local_save = self.topology.persist  # MasterMetaStore.save, set in __init__

        def persist(mv, fk):
            if local_save is not None:
                local_save(mv, fk)
            self._seq_latest = (mv, fk)
            self._seq_event.set()

        self.topology.persist = persist
        threading.Thread(target=self._seq_propose_loop, daemon=True).start()
        # id label: several masters can share one process (tests); the
        # samplers are removed again in stop()
        me = self.advertise
        stats.RAFT_STATE.set_function(lambda: self.raft.term, field="term", id=me)
        stats.RAFT_STATE.set_function(lambda: 1.0 if self.raft.is_leader else 0.0,
                                      field="is_leader", id=me)
        stats.RAFT_STATE.set_function(lambda: self.raft.commit_index, field="commit_index", id=me)
        self.raft.start()

    def _on_raft_leader(self) -> None:
        """Sequence safety on takeover: watermark replication is async
        (apply-side fsyncs must not run inside assign's topology lock), so
        the last committed ceiling may trail what the old leader issued by
        up to the in-flight window.  A new leader therefore jumps both
        watermarks past anything the deposed leader could have handed out
        while it still legitimately led (check-quorum bounds that window
        to one election timeout) and replicates the jump before serving:
        this hook (which runs under the raft lock, before the role flips)
        arms a barrier, and the id-issuing paths block on
        ``sequence_ready()`` until the jump entry commits."""
        mv, fk = self.topology.sequence_watermarks()
        # The jump base must be the newest watermark entry IN THE LOG, not
        # just applied topology state: commit_index propagation lags one
        # heartbeat, so a follower promoted right after the old leader's
        # last watermark replicated can hold that entry committed but
        # unapplied; jumping from applied state would spend the margin
        # covering the apply lag instead of the old leader's in-flight
        # issuance window (reissued volume ids under kill-the-leader).  The
        # election restriction guarantees the log has every committed
        # entry; an uncommitted seq entry only overshoots, which is safe.
        # This hook runs under the raft lock, so reading the log is safe.
        for entry in reversed(self.raft.log):
            cmd = entry.get("c") or {}
            if "seq" in cmd:
                lmv, lfk = cmd["seq"]
                mv, fk = max(mv, int(lmv)), max(fk, int(lfk))
                break
        self.topology.restore_sequence(mv + 64, fk + 2 * self.topology.FILE_KEY_MARGIN)
        self._seq_committed.clear()
        self._seq_barrier_armed = time.monotonic()
        self.topology._persist()  # local fsync + wakes the proposer
        self._seq_barrier = self._seq_latest
        if wlog.V(1):
            wlog.info("master %s: raft leader at term %d", self.advertise, self.raft.term)

    def _raft_apply(self, cmd: dict) -> None:
        # a follower adopts the leader's watermarks and persists them.  The
        # leader's own state is authoritative and already persisted through
        # the topology hook; restoring its echoed ceiling would move its next
        # file key up to that ceiling, so the next assign would cross it
        # again: a margin of keys, a meta fsync and a raft entry per assign
        # (what the JAX master does).  A new leader's takeover jump already
        # covers every seq entry in its log, applied or not.
        if "seq" in cmd and not self.raft.is_leader:
            mv, fk = cmd["seq"]
            self.topology.restore_sequence(int(mv), int(fk))
            if self.meta_store is not None:
                self.meta_store.save(*self.topology.sequence_watermarks())

    def _seq_propose_loop(self) -> None:
        while not self._stop.is_set():
            if not self._seq_event.wait(0.5):
                continue
            self._seq_event.clear()
            if self.raft is None:
                continue
            if not self.raft.is_leader:
                if (not self._seq_committed.is_set()
                        and time.monotonic() - self._seq_barrier_armed < 2.0):
                    # raced the takeover hook (it wakes us before the role
                    # flips): keep the wake pending so the jump is proposed
                    # as soon as the role is visible.  Bounded: a node that
                    # stepped down with the barrier still pending must not
                    # spin as a follower; a re-election re-arms and wakes us
                    self._seq_event.set()
                    time.sleep(0.05)
                continue
            mv, fk = self._seq_latest
            if self.raft.propose({"seq": [mv, fk]}):
                if (mv, fk) >= self._seq_barrier:
                    self._seq_committed.set()
            elif self.raft.is_leader:
                # timeout (quorum blip) while still leading: the issued
                # watermark must eventually commit or a later takeover
                # jumps from a stale ceiling; retry, latest-wins
                self._seq_event.set()
                time.sleep(0.2)

    def _adopt_peer_watermarks(self, info: dict) -> None:
        """Every election ping carries the peer's sequence watermarks; a
        standby adopts them so takeover never reissues ids the old leader
        handed out.  The leader itself must not adopt: its own state is
        authoritative, and re-importing its ceiling echoed back by
        followers would burn a margin of keys (and an fsync) every probe
        interval."""
        if self.is_leader:
            return
        self.topology.restore_sequence(int(info.get("max_volume_id", 0)),
                                       int(info.get("file_key_ceiling", 0)))

    def set_peers(self, peers: list[str]) -> None:
        """Update the peer set (tests bind dynamic ports)."""
        self._peers = peers
        if self.raft is not None:
            # raft membership changes go through the replicated log
            # (cluster.raft.add / cluster.raft.remove), not peer hints
            return
        if self.election:
            self.election.set_peers(peers)
            if peers and self.election._thread is None:
                self.election.start()

    def stop(self) -> None:
        self._stop.set()
        if self.raft is not None:
            self.raft.stop()
            for f in ("term", "is_leader", "commit_index"):
                stats.RAFT_STATE.remove(field=f, id=self.advertise)
        if self.election:
            self.election.stop()
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server is not None:
            # wait for termination: a mid-grace return leaves the port
            # half-dead (client RPCs get CANCELLED, not UNAVAILABLE)
            self._grpc_server.stop(grace=0.5).wait()
