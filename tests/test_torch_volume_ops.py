"""The port's volume.* and collection.* shell commands and the volume
server RPCs under them (VolumeVacuum, VolumeCopy, VolumeNeedleIds,
VolumeConfigureReplication, VolumeServerLeave), held against the JAX
package: the same plans on seeded topologies (volume.balance,
volume.fix.replication, volume.server.evacuate, printed through the
``-noApply`` flags) and the same listings, then a port cluster driven by
the port's and the JAX shell: vacuum, copy, move, fix.replication,
check.disk, mark, mount, configure.replication, deleteEmpty, evacuate and
leave, collection.delete, repair.status and tier.move between disk types."""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile

import grpc
import numpy as np
import pytest

from seaweedfs_tpu.pb import master_pb2 as jax_m_pb
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.shell import SHELL_REGISTRY as JAX_REGISTRY
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell import command_volume_balance as jax_balance
from seaweedfs_tpu.shell import command_volume_ops as jax_ops
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.storage import scrub as jax_scrub
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2 as m_pb
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.shell import SHELL_REGISTRY, run_command
from seaweedfs_tpu_torch.shell import command_volume_balance as balance
from seaweedfs_tpu_torch.shell import command_volume_ops as ops
from seaweedfs_tpu_torch.shell.command_env import CommandEnv

from test_torch_volume_server import Aborted, Context, _files
from test_torch_write_path import _http
from test_torch_write_path import _wait as _wait_with

WAIT_S = 30.0  # each poll's deadline


def _wait(predicate, what: str) -> None:
    _wait_with(predicate, what, WAIT_S)


PLACEMENTS = ("000", "001", "010", "100", "011")


# -- plans on seeded topologies -------------------------------------------------------


def _topology(seed: int, pb) -> "pb.TopologyInfo":
    """A seeded cluster view: 2 data centers x 2 racks x 2-3 nodes of 3-10
    slots; volumes of three collections at the placements above, held by
    fewer, exactly or more nodes than their placement asks for."""
    rng = np.random.default_rng(seed)
    nodes = []
    for dc in range(2):
        for rack in range(2):
            for i in range(int(rng.integers(2, 4))):
                nodes.append((f"dc{dc}", f"r{dc}{rack}", f"n{dc}{rack}{i}", int(rng.integers(3, 11))))
    held: dict[str, list] = {n[2]: [] for n in nodes}
    for vid in range(1, int(rng.integers(8, 20))):
        rp = PLACEMENTS[int(rng.integers(0, len(PLACEMENTS)))]
        want = 1 + sum(int(c) for c in rp) + int(rng.integers(-1, 2))
        room = [n for n in nodes if len(held[n[2]]) < n[3]]
        picks = rng.choice(len(room), size=min(max(1, want), len(room)), replace=False)
        coll = ("", "a", "b")[int(rng.integers(0, 3))]
        for p in picks:
            held[room[p][2]].append(pb.VolumeStat(
                id=vid, collection=coll, replica_placement=rp, size=1000 * vid,
                file_count=int(rng.integers(0, 5)), read_only=bool(rng.integers(0, 4) == 0)))
    topo = pb.TopologyInfo(id="topo")
    for dc in sorted({n[0] for n in nodes}):
        dci = pb.DataCenterInfo(id=dc)
        for rack in sorted({n[1] for n in nodes if n[0] == dc}):
            dns = []
            for _dc, _r, node, slots in (n for n in nodes if n[1] == rack):
                disk = pb.DiskInfo(type="hdd", max_volume_count=slots,
                                   volume_count=len(held[node]),
                                   free_volume_count=slots - len(held[node]))
                disk.volume_infos.extend(held[node])
                dns.append(pb.DataNodeInfo(id=node, url=f"{node}:8080", grpc_port=18080,
                                           disk_infos={"hdd": disk}))
            dci.rack_infos.append(pb.RackInfo(id=rack, data_node_infos=dns))
        topo.data_center_infos.append(dci)
    return topo


class _PlanEnv:
    """A shell env over a fixed topology: plans only, no RPC."""

    def __init__(self, topo, pb):
        self.resp = pb.VolumeListResponse(topology_info=topo, volume_size_limit_mb=30 * 1024)

    def confirm_is_locked(self) -> None:
        pass

    def collect_topology(self):
        return self.resp


def _print(runner, env, line: str) -> str:
    out = io.StringIO()
    runner(env, line, out)
    return out.getvalue()


SEEDS = range(16)


@pytest.mark.parametrize("seed", SEEDS)
def test_balance_plans_match_jax(seed):
    for coll in (None, "a"):
        plans = []
        for pb, mod in ((m_pb, balance), (jax_m_pb, jax_balance)):
            mover = mod.PlanVolumeMover()
            mod.balance_volumes_view(mod.collect_volume_nodes(_topology(seed, pb)), mover,
                                     collection=coll)
            plans.append(mover.plan)
        assert plans[0] == plans[1], coll


@pytest.mark.parametrize("seed", SEEDS)
def test_fix_replication_plans_match_jax(seed):
    for coll in (None, "", "b"):
        plans = []
        for pb, mod in ((m_pb, ops), (jax_m_pb, jax_ops)):
            under, over = mod.plan_fix_replication(
                mod._collect_nodes(_PlanEnv(_topology(seed, pb), pb)), coll)
            plans.append(([(v, s.id, d.id) for v, s, d in under], [(v, n.id) for v, n in over]))
        assert plans[0] == plans[1], coll


@pytest.mark.parametrize("seed", SEEDS[:6])
def test_plan_only_commands_print_what_the_jax_shell_prints(seed):
    lines = ["volume.list", "volume.balance -noApply", "volume.balance -noApply -collection b",
             "volume.fix.replication -noApply", "volume.deleteEmpty",
             "volume.server.evacuate -node n000 -noApply"]
    for line in lines:
        got = _print(run_command, _PlanEnv(_topology(seed, m_pb), m_pb), line)
        want = _print(jax_run_command, _PlanEnv(_topology(seed, jax_m_pb), jax_m_pb), line)
        assert got == want, line


def test_ported_commands_are_the_jax_shell_s():
    """Every volume.* and collection.* command of the JAX shell is ported,
    with the same help (volume.fsck with the filer)."""
    jax_names = {n for n in JAX_REGISTRY if n.startswith(("volume.", "collection."))}
    names = {n for n in SHELL_REGISTRY if n.startswith(("volume.", "collection."))}
    assert jax_names - names == set()
    assert names <= jax_names
    assert {n: SHELL_REGISTRY[n].help for n in names} == {n: JAX_REGISTRY[n].help for n in names}


# -- the maintenance RPCs against the JAX servicer --------------------------------------


@pytest.fixture
def servicers(tmp_path):
    """The same needle volume served by the port's servicer and the JAX
    one (its scrubber built as the JAX server's start() would)."""
    from test_torch_ec_read import write_needle_volume

    src = tmp_path / "src"
    src.mkdir()
    vol = write_needle_volume(str(src), seed=5, n=200, big=2, dead=40)
    dirs = {k: tmp_path / k for k in ("port", "ref")}
    for d in dirs.values():
        shutil.copytree(src, d)
    ref = jax_vs.VolumeServer([str(dirs["ref"])], "127.0.0.1:1")
    ref.scrubber = jax_scrub.VolumeScrubber(ref.store, interval_s=0)
    port = volume_server.VolumeServer([str(dirs["port"])], port=0, grpc_port=0, device="cpu",
                                      scrub_interval_s=0)
    port.start()
    try:
        yield (volume_server.VolumeServerGrpcServicer(port), jax_vs.VolumeServerGrpcServicer(ref),
               dirs, vol)
    finally:
        port.stop()
        ref.stop()


def _both(servicers, method: str, request):
    out = []
    for s in servicers[:2]:
        try:
            out.append((getattr(s, method)(request, Context()), None))
        except Aborted as e:
            out.append((None, (e.code, e.details)))
    assert out[0] == out[1], method
    return out[0]


def test_maintenance_rpcs_answer_as_jax(servicers):
    dirs = servicers[2]
    ids, _ = _both(servicers, "volume_needle_ids", vs_pb.VolumeNeedleIdsRequest(volume_id=1))
    assert len(ids.keys) == len(servicers[3]["live"])
    for method, req in (("volume_needle_ids", vs_pb.VolumeNeedleIdsRequest(volume_id=9)),
                        ("volume_vacuum", vs_pb.VolumeVacuumRequest(volume_id=9)),
                        ("volume_scrub", vs_pb.VolumeScrubRequest(volume_id=9)),
                        ("volume_configure_replication",
                         vs_pb.VolumeConfigureReplicationRequest(volume_id=9, replication="001")),
                        ("volume_configure_replication",
                         vs_pb.VolumeConfigureReplicationRequest(volume_id=1, replication="9x"))):
        _out, err = _both(servicers, method, req)
        assert err is not None and err[0] in (grpc.StatusCode.NOT_FOUND,
                                              grpc.StatusCode.INVALID_ARGUMENT), method
    _both(servicers, "volume_configure_replication",
          vs_pb.VolumeConfigureReplicationRequest(volume_id=1, replication="010"))
    none, _ = _both(servicers, "volume_vacuum",
                    vs_pb.VolumeVacuumRequest(volume_id=1, garbage_threshold=0.99))
    assert none.reclaimed_bytes == 0
    scrubbed, _ = _both(servicers, "volume_scrub", vs_pb.VolumeScrubRequest(volume_id=1, repair=True))
    assert scrubbed.results[0].scanned == len(servicers[3]["live"])
    done, _ = _both(servicers, "volume_vacuum", vs_pb.VolumeVacuumRequest(volume_id=1,
                                                                         garbage_threshold=0.0))
    assert done.reclaimed_bytes > 0
    after, _ = _both(servicers, "volume_needle_ids", vs_pb.VolumeNeedleIdsRequest(volume_id=1))
    assert sorted(after.keys) == sorted(ids.keys)
    left, _ = _both(servicers, "volume_server_leave", vs_pb.VolumeServerLeaveRequest())
    assert left == vs_pb.VolumeServerLeaveResponse()
    for s in servicers[:2]:
        s.vs.store.close()
    assert _files(str(dirs["port"])) == {k: v for k, v in _files(str(dirs["ref"])).items()
                                         if k in _files(str(dirs["port"]))}


# -- a port cluster, driven by both shells ----------------------------------------------


N_SERVERS = 3


@pytest.fixture(scope="module")
def cluster():
    master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.topology.dead_node_timeout = 2.0
    master.start()
    dirs, servers = [], []
    for i in range(N_SERVERS):
        dirs.append(tempfile.mkdtemp(prefix=f"torch-vops-{i}-"))
        vs = volume_server.VolumeServer([dirs[-1]], master.grpc_address, port=0, grpc_port=0,
                                        rack=f"rack{i % 2}", heartbeat_interval=0.2,
                                        device="cpu", scrub_interval_s=0,
                                        max_volume_counts=[60])
        vs.start()
        servers.append(vs)
    _wait(lambda: len(master.topology.nodes) == N_SERVERS, "every server's heartbeat")
    yield dict(master=master, servers=servers, dirs=dirs)
    for vs in servers:
        vs.stop()
    master.stop()
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def _env(cluster, shell: str):
    maddr = cluster["master"].grpc_address
    if shell == "port":
        return run_command, CommandEnv(maddr)
    return jax_run_command, JaxCommandEnv(maddr, client_name="vops-suite")


def _shell(cluster, shell: str, line: str) -> str:
    runner, env = _env(cluster, shell)
    out = io.StringIO()
    runner(env, "lock", out)
    try:
        runner(env, line, out)
    finally:
        runner(env, "unlock", out)  # a failed command must not leave the lock held
    return out.getvalue()


def _nid(vs) -> str:
    return vs.url


def _fill(cluster, collection: str, replication: str, n: int) -> dict:
    """n needles into ``collection``; {fid: payload} of the volume that
    took the most of them."""
    maddr = cluster["master"].advertise
    out = {}
    for i in range(n):
        status, body = _http(maddr, "GET", f"/dir/assign?collection={collection}"
                                           f"&replication={replication}")
        assert status == 200, body
        a = json.loads(body)
        out[a["fid"]] = np.random.default_rng(i).bytes(500 + 37 * i)
        assert _http(a["url"], "POST", f"/{a['fid']}", out[a["fid"]])[0] == 201
    vids = [int(f.split(",")[0]) for f in out]
    vid = max(set(vids), key=vids.count)
    return {f: d for f, d in out.items() if int(f.split(",")[0]) == vid}


def _holders(cluster, vid: int) -> list:
    return [vs for vs in cluster["servers"] if vs.store.find_volume(vid) is not None]


def _at_master(cluster, vid: int) -> set:
    return {n.id for n in cluster["master"].topology.lookup(vid)}


def _settled(cluster, vid: int) -> None:
    """Wait until the master's census of vid equals the servers' disks."""
    _wait(lambda: _at_master(cluster, vid) == {vs.url for vs in _holders(cluster, vid)},
          f"the master's census of volume {vid}")


def _counts_settled(cluster) -> bool:
    """Every volume row at the master holds its holder's file count."""
    by_url = {vs.url: vs for vs in cluster["servers"]}
    for node in list(cluster["master"].topology.nodes.values()):
        for vid, rec in list(node.volumes.items()):
            vol = by_url[node.id].store.find_volume(vid) if node.id in by_url else None
            if vol is None or rec.file_count != vol.file_count():
                return False
    return True


def _dat(vs, vid: int) -> bytes:
    with open(vs.store.find_volume(vid).base + ".dat", "rb") as f:
        return f.read()


@pytest.mark.parametrize("shell", ["port", "jax"])
def test_vacuum_reclaims_the_deleted_bytes_on_every_holder(cluster, shell):
    needles = _fill(cluster, f"vac{shell}", "001", 50)
    fids = sorted(needles)
    vid = int(fids[0].split(",")[0])
    holders = _holders(cluster, vid)
    assert len(holders) == 2
    gone = fids[: len(fids) // 2]
    for fid in gone:
        assert _http(holders[0].url, "DELETE", f"/{fid}")[0] == 202
    garbage = {vs.url: vs.store.find_volume(vid).deleted_bytes() for vs in holders}
    sizes = {vs.url: vs.store.find_volume(vid).dat_size() for vs in holders}
    assert all(vs.store.find_volume(vid).garbage_ratio() > 0.3 for vs in holders)
    text = _shell(cluster, shell, f"volume.vacuum -garbageThreshold 0.3 -volumeId {vid}")
    for vs in holders:
        v = vs.store.find_volume(vid)
        assert f"volume {vid} on {vs.url}: reclaimed {garbage[vs.url]} bytes" in text
        assert sizes[vs.url] - v.dat_size() == garbage[vs.url]
        assert v.super_block.compaction_revision == 1 and v.garbage_ratio() == 0.0
    assert f"total reclaimed: {sum(garbage.values())} bytes" in text
    for fid, data in needles.items():
        for vs in holders:
            assert _http(vs.url, "GET", f"/{fid}") == ((404, b"not found") if fid in gone
                                                       else (200, data))
    assert "total reclaimed: 0 bytes" in _shell(cluster, shell, f"volume.vacuum -volumeId {vid}")


@pytest.mark.parametrize("shell", ["port", "jax"])
def test_copy_then_move(cluster, shell):
    needles = _fill(cluster, f"mv{shell}", "000", 10)
    vid = int(next(iter(needles)).split(",")[0])
    (src,) = _holders(cluster, vid)
    others = [vs for vs in cluster["servers"] if vs is not src]
    _settled(cluster, vid)
    text = _shell(cluster, shell,
                  f"volume.copy -volumeId {vid} -source {_nid(src)} -target {_nid(others[0])}")
    assert f"copied volume {vid} {src.url} -> {others[0].url}" in text
    assert _dat(others[0], vid) == _dat(src, vid)
    _settled(cluster, vid)
    text = _shell(cluster, shell,
                  f"volume.move -volumeId {vid} -source {_nid(src)} -target {_nid(others[1])}")
    assert f"moved volume {vid} {src.url} -> {others[1].url}" in text
    assert src.store.find_volume(vid) is None
    assert not os.path.exists(os.path.join(cluster["dirs"][cluster["servers"].index(src)],
                                           f"mv{shell}_{vid}.dat"))
    _settled(cluster, vid)
    assert _at_master(cluster, vid) == {others[0].url, others[1].url}
    for fid, data in needles.items():
        assert _http(others[1].url, "GET", f"/{fid}") == (200, data)
    assert not others[1].store.find_volume(vid).read_only  # writable again on its new home


@pytest.mark.parametrize("shell", ["port", "jax"])
def test_fix_replication_restores_a_deleted_replica(cluster, shell):
    needles = _fill(cluster, f"fix{shell}", "001", 20)
    vid = int(next(iter(needles)).split(",")[0])
    holders = _holders(cluster, vid)
    want = _dat(holders[0], vid)
    _settled(cluster, vid)
    _shell(cluster, shell, f"volume.delete -volumeId {vid} -node "
                           f"{holders[1].ip}:{holders[1].grpc_port}")
    _settled(cluster, vid)
    assert len(_at_master(cluster, vid)) == 1
    text = _shell(cluster, shell, f"volume.fix.replication -collection fix{shell}")
    assert f"replicate volume {vid}: {holders[0].url} -> " in text
    assert "fixed 1 under- and 0 over-replicated" in text
    again = _holders(cluster, vid)
    assert len(again) == 2 and all(_dat(vs, vid) == want for vs in again)


@pytest.mark.parametrize("sync", [False, True], ids=["copy_back", "sync_deletions"])
def test_check_disk_makes_the_holders_agree(cluster, sync):
    needles = _fill(cluster, f"chk{int(sync)}", "001", 20)
    fids = sorted(needles)
    vid = int(fids[0].split(",")[0])
    holders = _holders(cluster, vid)
    for fid in fids[:5]:  # deleted on one holder only
        assert _http(holders[0].url, "DELETE", f"/{fid}?type=replicate")[0] == 202
    flag = " -syncDeletions" if sync else ""
    plan = _shell(cluster, "port", f"volume.check.disk -volumeId {vid} -noApply{flag}")
    want_line = (f"volume {vid}: +0 needles copied, -5 deletions synced" if sync
                 else f"volume {vid}: +5 needles copied, -0 deletions synced")
    assert want_line in plan and "(plan only)" in plan
    assert want_line in _shell(cluster, "jax", f"volume.check.disk -volumeId {vid} -noApply{flag}")
    text = _shell(cluster, "port", f"volume.check.disk -volumeId {vid}{flag}")
    assert want_line in text
    live = [sorted(vs.store.find_volume(vid).nm.db._m) for vs in holders]
    assert live[0] == live[1] and len(live[0]) == (15 if sync else 20)
    for fid in needles:
        got = [_http(vs.url, "GET", f"/{fid}")[0] for vs in holders]
        assert got == ([404, 404] if sync and fid in fids[:5] else [200, 200])


def test_mark_unmount_mount_configure_and_grow(cluster):
    needles = _fill(cluster, "ops", "000", 5)
    fid = next(iter(needles))
    vid = int(fid.split(",")[0])
    (vs,) = _holders(cluster, vid)
    for shell in ("port", "jax"):
        assert (f"marked volume {vid} readonly on 1 nodes"
                in _shell(cluster, shell, f"volume.mark -volumeId {vid}"))
        assert vs.store.find_volume(vid).read_only
        _shell(cluster, shell, f"volume.mark -volumeId {vid} -writable")
        assert not vs.store.find_volume(vid).read_only
        _shell(cluster, shell, f"volume.unmount -node {vs.url} -volumeId {vid}")
        assert vs.store.find_volume(vid) is None
        assert _http(vs.url, "GET", f"/{fid}")[0] in (302, 404)
        _wait(lambda: not _at_master(cluster, vid), "the unmount at the master")
        _shell(cluster, shell, f"volume.mount -node {vs.url} -volumeId {vid} -collection ops")
        assert _http(vs.url, "GET", f"/{fid}") == (200, needles[fid])
        _wait(lambda: _at_master(cluster, vid) == {vs.url}, "the mount at the master")
    text = _shell(cluster, "port", f"volume.configure.replication -volumeId {vid} "
                                   "-replication 001")
    assert f"volume {vid} on {vs.url}: replication -> 001" in text
    assert str(vs.store.find_volume(vid).super_block.replica_placement) == "001"
    _wait(lambda: any(n.volumes[vid].replica_placement == "001"
                      for n in cluster["master"].topology.nodes.values() if vid in n.volumes),
          "the new placement at the master")
    fixed = _shell(cluster, "jax", "volume.fix.replication -collection ops")
    assert f"replicate volume {vid}" in fixed and len(_holders(cluster, vid)) == 2
    before = cluster["master"].topology.max_volume_id
    grown = _shell(cluster, "port", "volume.grow -collection grown -count 2")
    assert "grew volumes" in grown and cluster["master"].topology.max_volume_id >= before + 2
    empty = [v for v in range(before + 1, cluster["master"].topology.max_volume_id + 1)]
    _wait(lambda: all(_at_master(cluster, v) for v in empty), "the grown volumes at the master")
    # the master learns a volume's file count from a full heartbeat (a new
    # volume's delta carries the count at its creation, in both packages):
    # an earlier test's volume filled under a second ago can still read 0
    _wait(lambda: _counts_settled(cluster), "every volume's file count at the master")
    text = _shell(cluster, "port", "volume.deleteEmpty -force")
    assert all(f"delete empty volume {v} on" in text for v in empty)
    assert not any(_holders(cluster, v) for v in empty)


def test_listings_and_collections_print_what_the_jax_shell_prints(cluster):
    _fill(cluster, "lista", "001", 4)
    _fill(cluster, "listb", "000", 4)
    for vid in range(1, cluster["master"].topology.max_volume_id + 1):
        _settled(cluster, vid)
    for line in ("volume.list", "collection.list"):
        # the same master state printed twice: a heartbeat landing between
        # the two reads (a size refresh) is waited out, not compared
        _wait(lambda: _shell(cluster, "port", line) == _shell(cluster, "jax", line),
              f"{line} printed alike by both shells")
    assert "volume id:" in _shell(cluster, "port", "volume.list")
    assert 'collection:"lista"' in _shell(cluster, "port", "collection.list")
    text = _shell(cluster, "jax", "collection.delete -collection listb")
    assert "deleted 1 volumes and 0 EC shards of collection 'listb'" in text
    _wait(lambda: 'collection:"listb"' not in _shell(cluster, "port", "collection.list"),
          "the collection gone at the master")
    status = _shell(cluster, "port", "volume.repair.status")
    assert all(f"{vs.url}: budget unlimited" in status for vs in cluster["servers"])
    assert status.splitlines()[-1] == _shell(cluster, "jax", "volume.repair.status").splitlines()[-1]


def test_balance_evacuate_and_leave(cluster):
    """Last on the module's cluster: it empties one server and lets it
    leave."""
    master, servers = cluster["master"], cluster["servers"]
    for vid in range(1, master.topology.max_volume_id + 1):
        _settled(cluster, vid)
    plan = _shell(cluster, "port", "volume.balance -noApply")
    assert plan == _shell(cluster, "jax", "volume.balance -noApply")
    text = _shell(cluster, "port", "volume.balance")
    assert text.count("volume.balance moved") == 1
    counts = [len(vs.store.locations[0].volumes) for vs in servers]
    assert max(counts) - min(counts) <= 1, counts
    for vid in range(1, master.topology.max_volume_id + 1):
        _settled(cluster, vid)  # every move's source deletion reached the master
    victim = servers[-1]
    held = sorted(victim.store.locations[0].volumes)
    text = _shell(cluster, "jax", f"volume.server.evacuate -node {victim.url}")
    assert f"evacuated {len(held)} volumes from {victim.url}" in text
    assert not victim.store.locations[0].volumes
    for vid in held:
        assert _holders(cluster, vid)
    _shell(cluster, "port", f"volume.server.leave -node {victim.url}")
    _wait(lambda: victim.url not in master.topology.nodes, "the leaving node pruned")
    assert victim._leaving.is_set() and not victim._stop.is_set()


def test_tier_move_lands_on_the_other_disk_type(tmp_path):
    master = master_server.MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.start()
    servers = []
    try:
        for i, kind in enumerate(("hdd", "ssd")):
            vs = volume_server.VolumeServer([str(tmp_path / kind)], master.grpc_address, port=0,
                                            grpc_port=0, rack=f"rack{i}", heartbeat_interval=0.2,
                                            device="cpu", disk_types=[kind], scrub_interval_s=0)
            vs.start()
            servers.append(vs)
        _wait(lambda: len(master.topology.nodes) == 2, "both servers")
        c = dict(master=master, servers=servers, dirs=[str(tmp_path / "hdd"), str(tmp_path / "ssd")])
        needles = _fill(c, "tier", "000", 6)
        vid = int(next(iter(needles)).split(",")[0])
        assert _holders(c, vid) == [servers[0]]
        _settled(c, vid)
        nope = rpc.volume_stub(f"{servers[0].ip}:{servers[0].grpc_port}")
        with pytest.raises(grpc.RpcError) as err:
            nope.VolumeCopy(vs_pb.VolumeCopyRequest(volume_id=vid, collection="tier",
                                                    source_data_node="127.0.0.1:1",
                                                    disk_type="ssd"))
        assert err.value.code() in (grpc.StatusCode.ALREADY_EXISTS,
                                    grpc.StatusCode.FAILED_PRECONDITION)
        text = _shell(c, "port", f"volume.tier.move -collection tier -toDiskType ssd")
        assert f"moved volume {vid} {servers[0].url}(hdd) -> {servers[1].url}(ssd)" in text
        assert _holders(c, vid) == [servers[1]]
        assert servers[1].store.disk_type_of(vid) == "ssd"
        for fid, data in needles.items():
            assert _http(servers[1].url, "GET", f"/{fid}") == (200, data)
    finally:
        for vs in servers:
            vs.stop()
        master.stop()
