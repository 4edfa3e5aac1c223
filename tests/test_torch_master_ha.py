"""The port's master HA on the CPU, held against the JAX package.

In-process port masters (``seaweedfs_tpu_torch.server.master_server``) in
lease and in raft mode, with port volume servers at ``device="cpu"``,
mirror tests/test_master_ha.py and tests/test_raft_master.py: durable
sequence state, failover and heartbeat re-homing, the node registry and
its TTL, election hysteresis, a standby adopting the watermarks, a raft
leader elected and its watermarks replicated, failover never reissuing
keys or volume ids, the ``Raft*`` admin RPCs through the port's shell and
the JAX shell, and a passive joiner added by ``cluster.raft.add``.  A
follower's forwarded RPCs, its ``/dir/*`` redirect and the HA HTTP routes
answer with the JAX master's status codes and bodies, and a raft group of
two port masters and one JAX master elects, replicates and fails over.

Election intervals are 0.3 s, as in the JAX tests; every wait polls with a
deadline of at least 30 s.
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import time

import grpc
import pytest

from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.util import resilience as jax_resilience
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.cluster import ClusterRegistry, LeaderElection
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.server import master_server as port_ms
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.util import resilience
from seaweedfs_tpu_torch.wdclient import AssignError, MasterClient

WAIT_S = 30.0
INTERVAL = 0.3


def wait_for(pred, timeout=WAIT_S, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def http_get(addr, path):
    host, port = addr.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.headers)
    finally:
        conn.close()


def get_follow(addr, path):
    """GET following one 307 (follower -> leader redirect)."""
    status, body, headers = http_get(addr, path)
    if status == 307:
        loc = headers["Location"].removeprefix("http://")
        redirect_addr, _, redirect_path = loc.partition("/")
        status, body, headers = http_get(redirect_addr, "/" + redirect_path)
    return status, body, headers


def single_leader(masters):
    leaders = [m for m in masters if m.is_leader]
    return leaders[0] if len(leaders) == 1 else None


def key_of(fid: str) -> int:
    return int(fid.split(",")[1][:-8], 16)


def stop_all(*servers):
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — already stopped by the test
            pass


# -- durable state, registry, hysteresis ----------------------------------------


def test_meta_persistence(tmp_path):
    mdir = str(tmp_path / "meta")
    m = MasterServer(port=0, grpc_port=0, meta_dir=mdir)
    m.start()
    vids = [m.topology.next_volume_id() for _ in range(3)]
    key = m.topology.next_file_key()
    m.stop()
    m2 = MasterServer(port=0, grpc_port=0, meta_dir=mdir)
    m2.start()
    try:
        assert m2.topology.next_volume_id() > max(vids)
        assert m2.topology.next_file_key() > key
    finally:
        m2.stop()
    # the JAX master resumes the port's meta dir the same way
    j = jax_ms.MasterServer(port=0, grpc_port=0, meta_dir=mdir)
    assert j.topology.next_volume_id() > max(vids) + 1
    assert j.topology.next_file_key() > key


def test_cluster_registry_ttl():
    reg = ClusterRegistry(ttl=0.2)
    reg.register("filer", "a:1")
    reg.register("broker", "b:1")
    assert [n.address for n in reg.list("filer")] == ["a:1"]
    assert len(reg.list()) == 2
    time.sleep(0.3)
    reg.register("broker", "b:1")  # a refreshed node survives
    assert [n.address for n in reg.list()] == ["b:1"]
    assert reg.list()[0].to_json()["type"] == "broker"


def test_election_hysteresis():
    e = LeaderElection("b:1", "b:2", peers=["a:1"], probe_timeout=0.05)
    # a:1 is unreachable, but pretend it was alive once
    e._alive = {"b:1": "b:2", "a:1": "a:2"}
    e.probe_once()
    assert e.leader_http == "a:1", "one missed probe must not flip leadership"
    e.probe_once()
    assert e.leader_http == "a:1"
    e.probe_once()  # the third consecutive miss demotes
    assert e.leader_http == "b:1"
    assert e.is_leader


class _Status(grpc.RpcError):
    def __init__(self, code):
        super().__init__(code.name)
        self._code = code

    def code(self):
        return self._code

    def details(self):
        return self._code.name


@pytest.mark.parametrize("answers", [
    ("UNAVAILABLE", "UNAVAILABLE", "ok"),  # rotates to the live master
    ("PERMISSION_DENIED", "ok", "ok"),  # an application error is the answer
    ("DEADLINE_EXCEEDED", "ok", "ok"),  # a hung master: the next one
    ("UNAVAILABLE", "UNAVAILABLE", "UNAVAILABLE"),  # every rotation fails
])
def test_failover_call_matches_jax(answers, monkeypatch, request):
    """``failover_call`` and ``call_unary`` try the masters, raise and
    retry as the JAX package's do."""
    monkeypatch.setattr(jax_resilience, "_sleep", lambda s: None)
    traces = {}
    for name, mod in (("port", resilience), ("jax", jax_resilience)):
        addrs = [f"{name}-{request.node.callspec.id}-{i}:1" for i in range(3)]
        tried, won = [], []

        def call_at(addr, mod=mod, tried=tried, addrs=addrs):
            def invoke():
                tried.append(addrs.index(addr))
                answer = answers[addrs.index(addr)]
                if answer != "ok":
                    raise _Status(getattr(grpc.StatusCode, answer))
                return "ok"

            return mod.call_unary(invoke, service="master", method="Assign", address=addr,
                                  max_attempts=1)

        try:
            got = mod.failover_call(addrs, call_at, on_success=lambda a, won=won, addrs=addrs:
                                    won.append(addrs.index(a)))
        except grpc.RpcError as e:
            got = e.code().name
        traces[name] = (got, tried, won)
    assert traces["port"] == traces["jax"]


# -- lease mode -------------------------------------------------------------------


@pytest.fixture()
def ha_cluster(tmp_path):
    m1 = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64, election_interval=INTERVAL)
    m2 = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64, election_interval=INTERVAL)
    m1.start()
    m2.start()
    peers = [m1.advertise, m2.advertise]
    m1.set_peers(peers)
    m2.set_peers(peers)
    assert wait_for(lambda: m1.leader_http == m2.leader_http)
    vs = VolumeServer([str(tmp_path / "v")], f"{m1.grpc_address},{m2.grpc_address}", port=0,
                      grpc_port=0, heartbeat_interval=0.2, device="cpu")
    vs.start()
    yield m1, m2, vs
    stop_all(vs, m1, m2)


def test_leader_failover_and_rehoming(ha_cluster):
    m1, m2, vs = ha_cluster
    leader, standby = (m1, m2) if m1.leader_http == m1.advertise else (m2, m1)
    assert wait_for(lambda: len(leader.topology.nodes) == 1)
    assert vs.master_address == leader.grpc_address
    # a follower answers unary RPCs by forwarding them to the leader
    resp = rpc.master_stub(standby.grpc_address).Assign(m_pb.AssignRequest(count=1, collection="ha"),
                                                        timeout=30)
    assert resp.fid and not resp.error
    first_key = key_of(resp.fid)
    # a follower redirects HTTP /dir/* to the leader
    status, _, headers = http_get(standby.advertise, "/dir/assign?collection=ha")
    assert status == 307
    assert headers["Location"] == f"http://{leader.advertise}/dir/assign?collection=ha"
    # lease mode replicates nothing: the standby is safe from reissuing the
    # key once its probe has adopted the leader's ceiling (as in the JAX
    # package; a key issued within one probe interval of the leader's death
    # can come again)
    assert wait_for(lambda: standby.topology.sequence_watermarks()[1]
                    >= leader.topology.sequence_watermarks()[1])
    # stop the leader: the standby takes over and the heartbeats re-home
    leader.stop()
    assert wait_for(lambda: standby.is_leader), "no takeover"
    assert wait_for(lambda: len(standby.topology.nodes) == 1
                    and vs.master_address == standby.grpc_address), "no re-homing"
    mc = MasterClient(f"{m1.grpc_address},{m2.grpc_address}")
    a = mc.assign(collection="ha")
    assert a.fid and key_of(a.fid) > first_key
    vid = int(a.fid.split(",")[0])
    assert wait_for(lambda: mc.lookup(vid) != [])
    status, body = vs._replica_pool.request(a.location.url, "POST", f"/{a.fid}", body=b"after")
    assert status == 201, body


def test_cluster_registry_http(ha_cluster):
    m1, m2, _ = ha_cluster
    status, _, _ = get_follow(m2.advertise, "/cluster/register?type=filer&address=127.0.0.1:8888")
    assert status == 200
    for m in (m1, m2):
        status, body, _ = get_follow(m.advertise, "/cluster/nodes?type=filer")
        assert [n["address"] for n in json.loads(body)["nodes"]] == ["127.0.0.1:8888"]
    status, body, _ = get_follow(m1.advertise, "/cluster/nodes?type=broker")
    assert json.loads(body)["nodes"] == []
    leader = single_leader([m1, m2])
    nodes = rpc.master_stub(leader.grpc_address).ListClusterNodes(
        m_pb.ListClusterNodesRequest(node_type="filer"), timeout=30).nodes
    assert [(n.address, n.node_type) for n in nodes] == [("127.0.0.1:8888", "filer")]


def test_standby_adopts_sequence_watermarks(ha_cluster):
    m1, m2, _ = ha_cluster
    leader, standby = (m1, m2) if m1.leader_http == m1.advertise else (m2, m1)
    issued = [leader.topology.next_file_key() for _ in range(5)]
    vid = leader.topology.next_volume_id()
    assert wait_for(lambda: standby.topology.sequence_watermarks()[0] >= vid
                    and standby.topology.sequence_watermarks()[1] > max(issued))
    assert standby.topology.next_file_key() > max(issued)
    assert standby.topology.next_volume_id() > vid


# -- a follower answers as the JAX follower does ----------------------------------


def _lease_pair(mod):
    pair = [mod.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64,
                             election_interval=INTERVAL) for _ in range(2)]
    for m in pair:
        m.start()
    for m in pair:
        m.set_peers([p.advertise for p in pair])
    assert wait_for(lambda: pair[0].leader_http == pair[1].leader_http)
    return pair


def _follower_answers(pair) -> dict:
    """Status codes and bodies of a follower's forwarded RPCs and HTTP
    routes, with the pair's own addresses replaced by placeholders."""
    leader = single_leader(pair)
    follower = next(m for m in pair if m is not leader)
    names = {leader.advertise: "LEADER_HTTP", follower.advertise: "FOLLOWER_HTTP",
             leader.grpc_address: "LEADER_GRPC", follower.grpc_address: "FOLLOWER_GRPC"}

    def norm(text):
        for addr, name in names.items():
            text = text.replace(addr, name)
        return text

    stub = rpc.master_stub(follower.grpc_address)
    out = {}
    out["assign"] = stub.Assign(m_pb.AssignRequest(count=1), timeout=30).error
    out["lookup"] = str(stub.LookupVolume(m_pb.LookupVolumeRequest(volume_or_file_ids=["9", "x"]),
                                          timeout=30))
    out["statistics"] = str(stub.Statistics(m_pb.StatisticsRequest(), timeout=30))
    stub.LeaseAdminToken(m_pb.LeaseAdminTokenRequest(lock_name="admin", client_name="first"),
                         timeout=30)
    try:
        stub.LeaseAdminToken(m_pb.LeaseAdminTokenRequest(lock_name="admin", client_name="second"),
                             timeout=30)
        out["lock"] = "granted"
    except grpc.RpcError as e:
        out["lock"] = (e.code().name, e.details())
    for rpc_name, req in (("RaftListClusterServers", m_pb.RaftListClusterServersRequest()),
                          ("RaftAddServer", m_pb.RaftAddServerRequest(id="x:1"))):
        try:
            getattr(stub, rpc_name)(req, timeout=30)
            out[rpc_name] = "ok"
        except grpc.RpcError as e:
            out[rpc_name] = (e.code().name, e.details())
    for path in ("/dir/assign?collection=c", "/dir/lookup?volumeId=9", "/cluster/raft/ps",
                 "/cluster/raft/add?address=x:1", "/cluster/nodes", "/cluster/register",
                 "/no/such/path"):
        status, body, headers = http_get(follower.advertise, path)
        out[path] = (status, norm(body.decode()), norm(headers.get("Location", "")))
    status, body, _ = http_get(leader.advertise, "/dir/lookup?volumeId=9")
    out["leader /dir/lookup"] = (status, body.decode())
    status, body, _ = http_get(leader.advertise, "/cluster/register?type=filer")
    out["leader /cluster/register"] = (status, body.decode())
    for m, who in ((leader, "leader"), (follower, "follower")):
        status, body, _ = http_get(m.advertise, "/cluster/status")
        st = json.loads(body)
        out[f"{who} /cluster/status"] = (status, st["IsLeader"], norm(st["Leader"]),
                                         sorted(norm(p) for p in st["Peers"]), st["MaxVolumeId"])
        status, body, _ = http_get(m.advertise, "/cluster/ping")
        ping = json.loads(body)
        out[f"{who} /cluster/ping"] = (status, sorted(ping), norm(ping["leader"]),
                                       norm(ping["grpc_address"]))
    return out


def test_follower_forwarding_and_redirects_match_jax():
    port_pair = _lease_pair(port_ms)
    jax_pair = _lease_pair(jax_ms)
    try:
        got, want = _follower_answers(port_pair), _follower_answers(jax_pair)
    finally:
        stop_all(*port_pair, *jax_pair)
    assert got == want
    assert got["/dir/assign?collection=c"][0] == 307
    assert got["lock"][0] == "PERMISSION_DENIED"
    assert got["RaftListClusterServers"] == ("FAILED_PRECONDITION",
                                             "this master does not run -ha raft")


# -- raft mode -------------------------------------------------------------------


def _raft_group(tmp_path, kinds=("port", "port", "port")):
    ports = free_ports(len(kinds))
    peers = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    for i, (kind, port) in enumerate(zip(kinds, ports)):
        mod = jax_ms if kind == "jax" else port_ms
        m = mod.MasterServer(port=port, grpc_port=0, peers=peers, meta_dir=str(tmp_path / f"m{i}"),
                             ha="raft", election_interval=INTERVAL, volume_size_limit_mb=64)
        m.start()
        masters.append(m)
    return masters


@pytest.fixture()
def raft_masters(tmp_path):
    masters = _raft_group(tmp_path)
    yield masters
    stop_all(*masters)


def test_raft_leader_elected_and_sequence_replicated(raft_masters):
    masters = raft_masters
    assert wait_for(lambda: single_leader(masters) is not None)
    ldr = single_leader(masters)
    followers = [m for m in masters if m is not ldr]
    assert wait_for(lambda: all(f.leader_http == ldr.advertise for f in followers))
    assert wait_for(lambda: all(f.leader_grpc == ldr.grpc_address for f in followers))
    assert ldr.sequence_ready(timeout=WAIT_S)
    vids = [ldr.topology.next_volume_id() for _ in range(3)]
    key = ldr.topology.next_file_key()
    assert wait_for(lambda: all(f.topology.sequence_watermarks()[0] >= max(vids)
                                for f in followers))
    metrics = http_get(ldr.advertise, "/metrics")[1].decode()
    assert f'weedtpu_master_raft{{field="is_leader",id="{ldr.advertise}"}} 1' in metrics
    ldr.stop()
    assert wait_for(lambda: single_leader(followers) is not None)
    new = single_leader(followers)
    assert new.sequence_ready(timeout=WAIT_S)  # the jump commits before issuing
    assert new.topology.next_volume_id() > max(vids)
    assert new.topology.next_file_key() > key


def test_failover_never_reissues_unreplicated_keys(raft_masters):
    """Stop the leader right after it hands out ids, before the async
    watermark propose can commit: the new leader's takeover jump still
    keeps every fresh id above the old ones."""
    masters = raft_masters
    assert wait_for(lambda: single_leader(masters) is not None)
    ldr = single_leader(masters)
    assert ldr.sequence_ready(timeout=WAIT_S)
    vids = [ldr.topology.next_volume_id() for _ in range(5)]
    keys = [ldr.topology.next_file_key() for _ in range(5)]
    ldr.stop()
    rest = [m for m in masters if m is not ldr]
    assert wait_for(lambda: single_leader(rest) is not None)
    new = single_leader(rest)
    assert new.sequence_ready(timeout=WAIT_S)
    assert new.topology.next_volume_id() > max(vids)
    assert new.topology.next_file_key() > max(keys)


@pytest.mark.parametrize("mod", [port_ms, jax_ms], ids=["port", "jax"])
def test_leader_keys_do_not_jump_at_each_watermark_commit(mod, tmp_path):
    """A raft leader hands out consecutive file keys: the commit of its own
    watermark entry must not move its next key up to the ceiling (one
    margin of keys, a meta fsync and a raft entry per assign).  The JAX
    master re-applies its own entries and jumps; the port's does not."""
    masters = _raft_group(tmp_path, kinds=("jax" if mod is jax_ms else "port",) * 3)
    try:
        assert wait_for(lambda: single_leader(masters) is not None)
        ldr = single_leader(masters)
        assert ldr.sequence_ready(timeout=WAIT_S)
        keys = []
        for _ in range(20):
            keys.append(ldr.topology.next_file_key())
            commit = ldr.raft.commit_index
            wait_for(lambda: ldr.raft.commit_index > commit, timeout=0.3)  # a proposal lands
        jumps = sum(b - a != 1 for a, b in zip(keys, keys[1:]))
        if mod is port_ms:
            assert jumps == 0, keys
        else:
            assert jumps > 0, keys
    finally:
        stop_all(*masters)


def test_raft_volume_servers_rehome_and_writes_stay_unique(raft_masters, tmp_path):
    """Port volume servers on the master list follow the raft leader; writes
    through MasterClient's master list continue after the leader stops, and
    no file key or volume id is issued twice."""
    masters = raft_masters
    assert wait_for(lambda: single_leader(masters) is not None)
    mlist = ",".join(m.grpc_address for m in masters)
    servers = []
    for i in range(2):
        d = tmp_path / f"v{i}"
        d.mkdir()
        servers.append(VolumeServer([str(d)], mlist, port=0, grpc_port=0, rack="r0",
                                    heartbeat_interval=0.2, device="cpu"))
    for vs in servers:
        vs.start()
    try:
        ldr = single_leader(masters)
        assert wait_for(lambda: len(ldr.topology.nodes) == 2)
        assert all(vs.master_address == ldr.grpc_address for vs in servers)
        mc = MasterClient(mlist)
        fids = []

        def write(n):
            while n:
                try:
                    a = mc.assign(collection="ha", replication="001")
                except (AssignError, grpc.RpcError):
                    time.sleep(0.1)  # the takeover window: retried, never dropped
                    continue
                status, _ = servers[0]._replica_pool.request(a.location.url, "POST",
                                                             f"/{a.fid}", body=a.fid.encode())
                if status == 201:
                    fids.append(a.fid)
                    n -= 1

        write(20)
        vids_before = {int(f.split(",")[0]) for f in fids}
        ldr.stop()
        rest = [m for m in masters if m is not ldr]
        assert wait_for(lambda: single_leader(rest) is not None)
        new = single_leader(rest)
        assert wait_for(lambda: len(new.topology.nodes) == 2
                        and all(vs.master_address == new.grpc_address for vs in servers))
        write(20)
        keys = [key_of(f) for f in fids]
        assert len(set(keys)) == len(keys) == 40
        assert min(keys[20:]) > max(keys[:20])
        for fid in fids:  # every acknowledged write is on both holders
            for vs in servers:
                status, body = vs._replica_pool.request(vs.url, "GET", f"/{fid}")
                assert (status, body) == (200, fid.encode())
        assert {int(f.split(",")[0]) for f in fids[20:]} <= vids_before | set(
            range(max(vids_before) + 1, new.topology.max_volume_id + 1))
    finally:
        stop_all(*servers)


def test_raft_grpc_admin_through_both_shells(raft_masters):
    masters = raft_masters
    assert wait_for(lambda: single_leader(masters) is not None)
    ldr = single_leader(masters)
    assert wait_for(lambda: all(m.leader_http == ldr.advertise for m in masters))
    st = rpc.master_stub(ldr.grpc_address).RaftListClusterServers(
        m_pb.RaftListClusterServersRequest(), timeout=30)
    assert st.leader == ldr.advertise
    assert len(st.servers) == 3
    assert sum(1 for s in st.servers if s.is_leader) == 1
    follower = next(m for m in masters if not m.is_leader)
    texts = {}
    for name, env, runner in (("port", CommandEnv(follower.grpc_address, client_name="t"),
                               run_command),
                              ("jax", JaxCommandEnv(follower.grpc_address, client_name="t"),
                               jax_run_command),
                              ("port list", CommandEnv(",".join(m.grpc_address for m in masters),
                                                       client_name="t"), run_command)):
        out = io.StringIO()
        runner(env, "cluster.raft.ps", out)
        texts[name] = out.getvalue()
        assert ldr.advertise in texts[name] and "leader" in texts[name]
        out = io.StringIO()
        runner(env, "cluster.ps", out)
        assert "raft" in out.getvalue() and "volume servers: 0" in out.getvalue()
    rows = {name: sorted(line.split()[:2] for line in text.splitlines()[1:])
            for name, text in texts.items()}
    assert rows["port"] == rows["jax"] == rows["port list"]
    assert sorted(r[0] for r in rows["port"]) == sorted(m.advertise for m in masters)


def test_raft_passive_joiner_added_via_shell(raft_masters, tmp_path):
    masters = raft_masters
    assert wait_for(lambda: single_leader(masters) is not None)
    ldr = single_leader(masters)
    (port,) = free_ports(1)
    joiner = MasterServer(port=port, grpc_port=0, peers=[], meta_dir=str(tmp_path / "joiner"),
                          ha="raft", election_interval=INTERVAL)
    joiner.start()
    try:
        time.sleep(1.0)
        assert not joiner.is_leader  # never self-elects
        env = CommandEnv(",".join(m.grpc_address for m in masters), client_name="t")
        out = io.StringIO()
        run_command(env, ["cluster.raft.add", "-id", joiner.advertise], out)
        assert joiner.advertise in out.getvalue()
        assert wait_for(lambda: len(joiner.raft.members) == 4
                        and joiner.leader_http == single_leader(masters).advertise)
        out = io.StringIO()
        run_command(env, ["cluster.raft.remove", "-id", joiner.advertise], out)
        assert wait_for(lambda: len(single_leader(masters).raft.members) == 3)
    finally:
        joiner.stop()


def test_mixed_raft_group_of_port_and_jax_masters(tmp_path):
    """Two port masters and one JAX master share one raft group over
    HTTP: one leader, its watermarks on every member, and a successor that
    never reissues ids, whichever package leads."""
    masters = _raft_group(tmp_path, kinds=("port", "port", "jax"))
    try:
        assert wait_for(lambda: single_leader(masters) is not None)
        ldr = single_leader(masters)
        assert ldr.sequence_ready(timeout=WAIT_S)
        vids = [ldr.topology.next_volume_id() for _ in range(3)]
        keys = [ldr.topology.next_file_key() for _ in range(3)]
        assert wait_for(lambda: all(m.topology.sequence_watermarks()[0] >= max(vids)
                                    for m in masters))
        assert wait_for(lambda: all(m.leader_http == ldr.advertise for m in masters))
        ldr.stop()
        rest = [m for m in masters if m is not ldr]
        assert wait_for(lambda: single_leader(rest) is not None)
        new = single_leader(rest)
        assert new.sequence_ready(timeout=WAIT_S)
        assert new.topology.next_volume_id() > max(vids)
        assert new.topology.next_file_key() > max(keys)
        out = io.StringIO()
        jax_run_command(JaxCommandEnv(new.grpc_address, client_name="t"), "cluster.raft.ps", out)
        assert new.advertise in out.getvalue()
    finally:
        stop_all(*masters)
