"""The port's cluster telemetry (cluster/telemetry.py, telemetry_server.py,
the master's ``telemetry_url``, ``cli master -telemetryUrl``) against the
JAX package's, crossed both ways: the port's collector reports to the JAX
``TelemetryServer`` and the JAX collector to the port's, and every server's
``/api/stats``, ``/api/instances`` and ``/metrics`` are equal with the
report times masked; a follower never reports; a real port master reports
its heartbeating volume server and its ``cluster.id``, which survives a
restart over one ``meta_dir`` (and which the JAX master reads too)."""

from __future__ import annotations

import http.client
import json
import time
from types import SimpleNamespace

import pytest

from seaweedfs_tpu.cluster import telemetry as jax_telemetry
from seaweedfs_tpu.cluster import telemetry_server as jax_telemetry_server
from seaweedfs_tpu_torch.cluster import telemetry as port_telemetry
from seaweedfs_tpu_torch.cluster import telemetry_server as port_telemetry_server
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

COLLECTORS = {"jax": jax_telemetry.TelemetryCollector, "port": port_telemetry.TelemetryCollector}
SERVERS = {"jax": jax_telemetry_server.TelemetryServer,
           "port": port_telemetry_server.TelemetryServer}
WAIT_S = 30.0


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _get(port: int, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port: int, path: str, body: bytes) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


def _fake_master(leader: bool = True):
    """What a collector reads of a master: three nodes (5 volume replicas),
    two EC volumes (6 shard copies), one filer and two brokers."""
    nodes = {"n1": SimpleNamespace(volumes={1: 0, 2: 0}), "n2": SimpleNamespace(volumes={1: 0}),
             "n3": SimpleNamespace(volumes={3: 0, 4: 0})}
    ec = {7: {0: {"n1"}, 1: {"n2", "n3"}}, 8: {13: {"n1", "n2", "n3"}}}
    kinds = {"filer": ["f1"], "broker": ["b1", "b2"]}
    return SimpleNamespace(topology=SimpleNamespace(nodes=nodes, ec_shard_map=ec),
                           is_leader=leader,
                           registry=SimpleNamespace(list=lambda kind: kinds.get(kind, [])))


def _views(port: int) -> dict:
    out = {}
    for path in ("/api/stats", "/api/instances", "/metrics"):
        status, body = _get(port, path)
        assert status == 200, path
        out[path] = body
    inst = json.loads(out["/api/instances"])
    for s in inst["instances"]:
        assert abs(s.pop("received_at") - time.time()) < 60
    out["/api/instances"] = inst
    out["/api/stats"] = json.loads(out["/api/stats"])
    return out


def test_reports_cross_both_ways_with_equal_bodies():
    master = _fake_master()
    snaps = {name: cls(master, "http://127.0.0.1:1/api/collect", cluster_id="itest").snapshot()
             for name, cls in COLLECTORS.items()}
    for s in snaps.values():
        assert abs(s.pop("ts") - time.time()) < 60
    assert snaps["jax"] == snaps["port"] == {
        "cluster_id": "itest", "version": "weed-tpu", "is_leader": True, "volume_servers": 3,
        "volumes": 5, "ec_shards": 6, "filers": 1, "brokers": 2}
    # (collector, server): both crossings and both packages alone
    servers = {}
    try:
        views = {}
        for reporter, receiver in (("port", "jax"), ("jax", "port"), ("jax", "jax"),
                                   ("port", "port")):
            srv = SERVERS[receiver](port=0).start()
            servers[(reporter, receiver)] = srv
            coll = COLLECTORS[reporter](master, f"http://127.0.0.1:{srv.port}/api/collect",
                                        cluster_id="itest")
            coll._post(coll.snapshot())
            views[(reporter, receiver)] = _views(srv.port)
        first = views[("port", "jax")]
        assert all(v == first for v in views.values())
        assert first["/api/stats"] == {
            "clusters": 1, "reports_received": 1, "total_volume_servers": 3, "total_volumes": 5,
            "total_ec_shards": 6, "total_filers": 1, "total_brokers": 2}
        assert b'weedtpu_cluster_ec_shards{cluster="itest"} 6' in first["/metrics"]
        # garbage is refused alike: bad JSON, no cluster id, an unknown path
        for srv in servers.values():
            assert _post(srv.port, "/api/collect", b"{not json") == 400
            assert _post(srv.port, "/api/collect", b"{}") == 400
            assert _post(srv.port, "/api/other", b"{}") == 404
            assert _get(srv.port, "/nope")[0] == 404
    finally:
        for srv in servers.values():
            srv.stop()


@pytest.mark.parametrize("reporter", sorted(COLLECTORS))
def test_a_follower_never_reports(reporter):
    master = _fake_master(leader=False)
    srv = port_telemetry_server.TelemetryServer(port=0).start()
    coll = COLLECTORS[reporter](master, f"{srv.url}/api/collect", interval=0.05,
                                cluster_id="follower")
    coll.start()
    try:
        time.sleep(0.6)
        assert (srv.received, coll.sent, coll.errors) == (0, 0, 0)
        master.is_leader = True
        _wait(lambda: srv.received >= 2, "two reports once leading")
        assert [s["cluster_id"] for s in srv.instances()] == ["follower"]
    finally:
        coll.stop()
        srv.stop()


def test_a_port_master_reports_to_the_jax_collector_and_keeps_its_cluster_id(tmp_path):
    """The port's master with ``meta_dir``: its reports reach the JAX
    collector with the heartbeating volume server counted and the id in
    ``cluster.id``; a restart over the same directory reports the same id,
    and the JAX master reads that file as its own."""
    srv = jax_telemetry_server.TelemetryServer(port=0).start()
    mdir = tmp_path / "m"
    mdir.mkdir()
    url = f"{srv.url}/api/collect"
    master = MasterServer(port=0, grpc_port=0, meta_dir=str(mdir), telemetry_url=url,
                          telemetry_interval=0.1)
    master.start()
    vs = None
    try:
        vs = VolumeServer([str(tmp_path / "v")], master.grpc_address, port=0, grpc_port=0,
                          heartbeat_interval=0.2, device="cpu")
        vs.start()
        cid = (mdir / "cluster.id").read_text().strip()
        assert len(cid) == 32 and master.telemetry.cluster_id == cid

        def reported(n: int) -> bool:
            inst = srv.instances()
            return bool(inst) and inst[0]["volume_servers"] == n

        _wait(lambda: reported(1), "a report with the volume server")
        (inst,) = srv.instances()
        assert inst["cluster_id"] == cid and inst["version"] == "weed-tpu"
        assert inst["volumes"] == sum(len(n.volumes) for n in master.topology.nodes.values())
    finally:
        if vs is not None:
            vs.stop()
        master.stop()
    assert not master.telemetry._thread.is_alive()
    sent = srv.received
    time.sleep(0.3)
    assert srv.received == sent  # a stopped master reports no more
    again = MasterServer(port=0, grpc_port=0, meta_dir=str(mdir), telemetry_url=url,
                         telemetry_interval=0.1)
    again.start()
    try:
        assert again.telemetry.cluster_id == cid
        _wait(lambda: srv.received > sent, "a report after the restart")
        assert [s["cluster_id"] for s in srv.instances()] == [cid]
    finally:
        again.stop()
        srv.stop()
    from seaweedfs_tpu.server.master_server import MasterServer as JaxMasterServer

    jax_master = JaxMasterServer(port=0, grpc_port=0, meta_dir=str(mdir))
    assert jax_master._durable_cluster_id() == cid


def test_a_jax_master_reports_to_the_port_collector(tmp_path):
    srv = port_telemetry_server.TelemetryServer(port=0).start()
    from seaweedfs_tpu.server.master_server import MasterServer as JaxMasterServer

    master = JaxMasterServer(port=0, grpc_port=0, meta_dir=str(tmp_path),
                             telemetry_url=f"{srv.url}/api/collect", telemetry_interval=0.1)
    master.start()
    try:
        _wait(lambda: srv.received >= 1, "the JAX master's report")
        (inst,) = srv.instances()
        assert inst["cluster_id"] == (tmp_path / "cluster.id").read_text().strip()
        assert (inst["volume_servers"], inst["volumes"], inst["ec_shards"]) == (0, 0, 0)
    finally:
        master.stop()
        srv.stop()
    # the port's master over the JAX master's directory keeps its id
    port_master = MasterServer(port=0, grpc_port=0, meta_dir=str(tmp_path),
                               telemetry_url=f"{srv.url}/api/collect")
    assert port_master.telemetry.cluster_id == inst["cluster_id"]
    assert MasterServer(port=0, grpc_port=0).telemetry is None  # off by default
