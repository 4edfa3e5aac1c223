"""The port's master side against the JAX package's: the same heartbeat
sequence (full state, volume deltas, EC deltas with the LRC class's
``local_groups``, a pruned node) fed to both masters' servicers gives
``VolumeList``, ``LookupVolume``, ``LookupEcVolume`` and ``CollectionList``
responses whose deterministic serialisations are equal; the admin lock
behaves the same under contention; and ``ec.balance`` plans the same moves
as the JAX package's on seeded random topologies (racks, free slots, disk
types, collections, RS and LRC volumes).  Nothing here needs a server:
the servicers are called in process."""

from __future__ import annotations

import time

import grpc
import numpy as np
import pytest

from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.shell import command_ec_balance as jax_balance
from seaweedfs_tpu.shell import ec_common as jax_ec_common
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.server import master_server
from seaweedfs_tpu_torch.shell import command_ec_balance, ec_common
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits


class Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(code, details)
        self.code, self.details = code, details


class Context:
    def abort(self, code, details):
        raise Aborted(code, details)


def _bits(ids) -> int:
    out = ShardBits(0)
    for s in ids:
        out = out.add(s)
    return int(out)


def _vol(vid, collection="", size=1000, files=3, read_only=False, disk_type="hdd", rp="000"):
    return m_pb.VolumeStat(id=vid, collection=collection, size=size, file_count=files,
                           read_only=read_only, replica_placement=rp, version=3,
                           disk_type=disk_type)


def _ec(vid, ids, collection="", k=10, m=4, groups=0, disk_type="hdd"):
    return m_pb.EcShardStat(volume_id=vid, collection=collection, shard_bits=_bits(ids),
                            data_shards=k, parity_shards=m, local_groups=groups,
                            disk_type=disk_type)


def _hb(node: int, **fields) -> m_pb.Heartbeat:
    return m_pb.Heartbeat(ip="127.0.0.1", port=18080 + node, grpc_port=28080 + node,
                          data_center="dc1", rack=f"rack{node % 2}", max_volume_count=8,
                          max_volume_counts={"hdd": 6, "ssd": 2}, **fields)


# (node, heartbeats sent on one stream), in order
HEARTBEAT_STEPS = [
    (0, [_hb(0, volumes=[_vol(1, size=5000), _vol(2, "pics", disk_type="ssd")],
             ec_shards=[_ec(7, range(0, 5)), _ec(9, [0, 3], "lrc", 10, 4, 2)])]),
    (1, [_hb(1, has_no_volumes=True, ec_shards=[_ec(7, range(5, 14))])]),
    (2, [_hb(2, volumes=[_vol(1, size=5000)], has_no_ec_shards=True),
         _hb(2, new_volumes=[_vol(3, "pics", read_only=True)]),
         _hb(2, new_ec_shards=[_ec(9, [1, 2, 4, 10], "lrc", 10, 4, 2)]),
         _hb(2, deleted_volumes=[_vol(1)])]),
    (3, [_hb(3, has_no_volumes=True, has_no_ec_shards=True),
         _hb(3, new_ec_shards=[_ec(9, [5, 6, 7, 8, 9, 11, 12, 13], "lrc", 10, 4, 2)]),
         _hb(3, deleted_ec_shards=[_ec(9, [13], "lrc", 10, 4, 2)])]),
    (0, [_hb(0, volumes=[_vol(1, size=9000, read_only=True), _vol(2, "pics", disk_type="ssd")],
             ec_shards=[_ec(7, range(0, 4))])]),
]


def _masters():
    port = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    ref = jax_ms.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    for ms in (port, ref):
        ms.grpc_port = 19333
    return ((port, master_server.MasterGrpcServicer(port)),
            (ref, jax_ms.MasterGrpcServicer(ref)))


def _queries(servicer) -> list[bytes]:
    out = [servicer.volume_list(m_pb.VolumeListRequest(), Context()),
           servicer.lookup_volume(m_pb.LookupVolumeRequest(
               volume_or_file_ids=["1", "2", "3,01637037d6", "7", "9", "42", "x"]), Context()),
           servicer.collection_list(m_pb.CollectionListRequest(), Context())]
    out += [servicer.lookup_ec_volume(m_pb.LookupEcVolumeRequest(volume_id=v), Context())
            for v in (7, 9, 42)]
    return [r.SerializeToString(deterministic=True) for r in out]


def test_heartbeat_sequence_gives_the_same_responses():
    (port, port_svc), (ref, ref_svc) = _masters()
    for step, (node, beats) in enumerate(HEARTBEAT_STEPS):
        got = list(port_svc.send_heartbeat(iter(beats), Context()))
        want = list(ref_svc.send_heartbeat(iter(beats), Context()))
        assert [r.SerializeToString(deterministic=True) for r in got] == \
            [r.SerializeToString(deterministic=True) for r in want], step
        assert _queries(port_svc) == _queries(ref_svc), f"after step {step} (node {node})"
    # the LRC class reaches the master through local_groups
    assert port.topology.ec_schemes[9] == (10, 4, 2)
    # node 3 misses its heartbeats: pruned on both, its shards forgotten
    for ms in (port, ref):
        ms.topology.dead_node_timeout = 5.0
        ms.topology.nodes["127.0.0.1:18083"].last_seen = time.monotonic() - 60
        assert ms.topology.prune_dead_nodes() == ["127.0.0.1:18083"]
    assert _queries(port_svc) == _queries(ref_svc)
    # node 0's last full resync dropped its shards 0 and 3 of volume 9
    assert sorted(port.topology.lookup_ec_shards(9)) == [1, 2, 4, 10]
    assert [n.id for n in port.topology.alive_nodes()] == [n.id for n in ref.topology.alive_nodes()]
    assert port.topology.collections() == ref.topology.collections() == {"", "pics", "lrc"}


def test_admin_lock_contention_matches_jax():
    (port, port_svc), (ref, ref_svc) = _masters()

    def run(svc) -> list:
        trace = []

        def lease(prev, client):
            try:
                r = svc.lease_admin_token(m_pb.LeaseAdminTokenRequest(
                    previous_token=prev, lock_name="admin", client_name=client), Context())
                trace.append(("ok", client, prev == r.token))
                return r.token
            except Aborted as e:
                trace.append((e.code, e.details))
                return 0

        a = lease(0, "shell-a")
        lease(0, "shell-b")  # held by a: denied
        a2 = lease(a, "shell-a")  # renewal keeps the token
        trace.append(a2 == a)
        svc.release_admin_token(m_pb.ReleaseAdminTokenRequest(previous_token=123,
                                                              lock_name="admin"), Context())
        lease(0, "shell-b")  # a wrong token released nothing
        svc.release_admin_token(m_pb.ReleaseAdminTokenRequest(previous_token=a,
                                                              lock_name="admin"), Context())
        b = lease(0, "shell-b")
        trace.append(b != 0)
        return trace

    got, want = run(port_svc), run(ref_svc)
    assert got == want
    assert got[1] == (grpc.StatusCode.PERMISSION_DENIED, "lock admin held by shell-a")
    # a lease that is not renewed expires after the TTL
    lock = master_server.AdminLock()
    lock.lease("admin", 0, "a")
    lock.TTL = 0.0
    assert lock.lease("admin", 0, "b")[0] != 0


# -- ec.balance plans --------------------------------------------------------


def _random_topology(seed: int) -> m_pb.TopologyInfo:
    """Seeded cluster: 2-4 racks over 1-2 DCs, 1-4 nodes a rack, free slots
    from max/volume counts, some nodes with an ssd disk too, and 1-4 EC
    volumes (RS(10,4), LRC(10,2,2), RS(6,3); collections "" and "c1")
    whose shards land on random nodes, some duplicated, some missing."""
    rng = np.random.default_rng(seed)
    dcs = [f"dc{i}" for i in range(int(rng.integers(1, 3)))]
    racks = [(dcs[i % len(dcs)], f"rack{i}") for i in range(int(rng.integers(2, 5)))]
    nodes = []
    for dc, rack in racks:
        for j in range(int(rng.integers(1, 5))):
            disks = {"hdd": m_pb.DiskInfo(type="hdd", max_volume_count=int(rng.integers(1, 10)),
                                          volume_count=int(rng.integers(0, 2)))}
            if rng.random() < 0.3:
                disks["ssd"] = m_pb.DiskInfo(type="ssd", max_volume_count=int(rng.integers(1, 4)))
            nodes.append((dc, rack, m_pb.DataNodeInfo(
                id=f"{rack}-n{j}", url=f"10.0.{len(nodes)}.1:8080", grpc_port=18080,
                disk_infos=disks)))
    schemes = [(10, 4, 0), (10, 4, 2), (6, 3, 0)]
    for vid in range(1, int(rng.integers(2, 6))):
        k, m, groups = schemes[int(rng.integers(0, 3))]
        coll = "c1" if rng.random() < 0.4 else ""
        holders: dict[int, list[int]] = {}
        for sid in range(k + m):
            if rng.random() < 0.05:
                continue  # a lost shard
            for _ in range(1 + int(rng.random() < 0.1)):  # some duplicated
                holders.setdefault(int(rng.integers(0, len(nodes))), []).append(sid)
        for n, sids in holders.items():
            dn = nodes[n][2]
            dt = "ssd" if "ssd" in dn.disk_infos and rng.random() < 0.3 else "hdd"
            dn.disk_infos[dt].ec_shard_infos.append(m_pb.EcShardStat(
                volume_id=vid, collection=coll, shard_bits=_bits(set(sids)), data_shards=k,
                parity_shards=m, local_groups=groups, disk_type=dt))
    topo = m_pb.TopologyInfo(id="topo")
    for dc in dcs:
        dci = m_pb.DataCenterInfo(id=dc)
        for rdc, rack in racks:
            if rdc == dc:
                dci.rack_infos.append(m_pb.RackInfo(
                    id=rack, data_node_infos=[dn for d, r, dn in nodes if (d, r) == (dc, rack)]))
        topo.data_center_infos.append(dci)
    return topo


BALANCE_CASES = [(seed, coll, tol, dt) for seed in range(16)
                 for coll, tol, dt in [(None, 0, ""), ("c1", 1, ""), (None, 0, "hdd")]]


@pytest.mark.parametrize("seed,collection,tolerance,disk_type", BALANCE_CASES,
                         ids=[f"seed{s}-{c}-tol{t}-{d or 'all'}" for s, c, t, d in BALANCE_CASES])
def test_balance_plan_matches_jax(seed, collection, tolerance, disk_type):
    topo = _random_topology(seed)
    plans, views = [], []
    for common, balance in ((ec_common, command_ec_balance), (jax_ec_common, jax_balance)):
        nodes, colls, schemes = common.collect_ec_nodes(topo, disk_type=disk_type)
        mover = balance.PlanEcMover()
        balance.balance_ec_shards_view(nodes, colls, mover, collection=collection,
                                       rack_tolerance=tolerance, schemes=schemes)
        plans.append(mover.plan)
        views.append({n.info.id: {v: int(b) for v, b in n.shards.items()} for n in nodes})
    assert plans[0] == plans[1]
    assert views[0] == views[1]
