"""The port's cluster EC path on the CPU, held against the JAX package.

- ``Volume``: the same seeded needles, written with the clock pinned
  through the port's and the JAX ``Volume``, give byte-identical .dat and
  .idx; reads, deletes, ``set_read_only`` across a reopen and a torn-tail
  reopen behave as the JAX package's do.
- The hedged remote read: a holder stalled past ``WEED_EC_HEDGE_MS`` loses
  to the next holder, a failing holder is forgotten, and the port's
  locator answers and counts as the JAX package's does.
- An in-process cluster of one port master and four port volume servers
  (``device="cpu"``, racks alternating), driven by the port's shell:
  ``ec.encode`` gives shards byte-identical to the JAX package's
  ``write_ec_files`` of the same .dat, spread over both racks; needle
  reads through ``EcShardLocator(master)`` go to the remote holders (no
  reconstruction) and, after a node is lost, reconstruct; ``ec.rebuild``
  restores the lost shards identically and ``ec.decode`` the original
  .dat; an LRC single loss stages only its local group; and the JAX
  package's own shell drives the port's servers to identical shards.

Every wait polls a condition with a deadline of at least 30 s."""

from __future__ import annotations

import hashlib
import io
import os
import re
import shutil
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.server import store_ec as jax_store_ec
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec_encoder
from seaweedfs_tpu.storage.erasure_coding.lrc import make_scheme as jax_make_scheme
from seaweedfs_tpu.storage.erasure_coding.scheme import DEFAULT_SCHEME as JAX_RS
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.util import resilience as jax_resilience
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.server import store_ec
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.storage import volume
from seaweedfs_tpu_torch.storage.erasure_coding.shard_bits import ShardBits
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import NotFoundError
from seaweedfs_tpu_torch.util import resilience

from test_torch_ec_read import write_needle_volume

N_SERVERS = 4
WAIT_S = 60.0


def _wait(predicate, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _files(directory) -> dict[str, bytes]:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


# -- Volume -----------------------------------------------------------------------


def _needles(seed: int, n: int, module) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        needle = module(id=int(rng.integers(1, 1 << 40)), cookie=int(rng.integers(0, 1 << 32)),
                        data=rng.bytes(int(rng.integers(1, 3000))))
        if i % 4 == 0:
            needle.name = f"n{i}.bin".encode()
            needle.flags |= FLAG_HAS_NAME
        out.append(needle)
    return out


@pytest.fixture
def two_volumes(tmp_path, monkeypatch):
    """The same 400 seeded needles (some overwritten, some deleted)
    written through the port's and the JAX Volume, the clock pinned."""
    clock = iter(range(1_700_000_000_000_000_000, 1_800_000_000_000_000_000, 1000))
    now = [0]

    def pinned() -> int:
        return now[0]

    monkeypatch.setattr(time, "time_ns", pinned)
    dirs = {"port": tmp_path / "port", "ref": tmp_path / "ref"}
    for d in dirs.values():
        d.mkdir()
    vols = {"port": volume.Volume(dirs["port"], 5, "c"), "ref": jax_volume.Volume(dirs["ref"], 5, "c")}
    needles = {"port": _needles(7, 400, Needle), "ref": _needles(7, 400, JaxNeedle)}
    rng = np.random.default_rng(8)
    deleted = set(int(i) for i in rng.choice(400, 40, replace=False))
    for i in range(400):
        now[0] = next(clock)
        got = [vols[k].write_needle(needles[k][i]) for k in ("port", "ref")]
        assert got[0] == got[1]
    for i in sorted(deleted):
        nid = needles["port"][i].id
        assert vols["port"].delete_needle(nid) == vols["ref"].delete_needle(nid)
    for i in range(0, 400, 50):  # overwrites (a deleted needle comes back)
        deleted.discard(i)
        now[0] = next(clock)
        for k in ("port", "ref"):
            needles[k][i].data = b"overwritten-%d" % i
            vols[k].write_needle(needles[k][i])
    yield vols, dirs, needles["port"], deleted
    for v in vols.values():
        v.close()


def test_volume_writes_match_jax_byte_for_byte(two_volumes):
    vols, dirs, needles, deleted = two_volumes
    assert vols["port"].last_append_at_ns == vols["ref"].last_append_at_ns  # the pinned clock
    for k in vols:
        vols[k].close()
    assert _files(dirs["port"]) == _files(dirs["ref"])
    assert sorted(_files(dirs["port"])) == ["c_5.dat", "c_5.idx"]
    vols["port"] = volume.Volume(dirs["port"], 5, "c", create=False)
    vols["ref"] = jax_volume.Volume(dirs["ref"], 5, "c", create=False)
    for i, n in enumerate(needles):
        if i in deleted:
            with pytest.raises(NotFoundError):
                vols["port"].read_needle(n.id)
            with pytest.raises(jax_volume.NotFoundError):
                vols["ref"].read_needle(n.id)
            continue
        got, want = vols["port"].read_needle(n.id, n.cookie), vols["ref"].read_needle(n.id, n.cookie)
        assert got.to_bytes() == want.to_bytes()
        assert got.data == n.data
    for k in ("file_count", "dat_size", "deleted_bytes"):
        assert getattr(vols["port"], k)() == getattr(vols["ref"], k)(), k
    for k in vols:  # reopened, the clock is the .dat's mtime
        assert vols[k].last_append_at_ns == int(os.path.getmtime(dirs[k] / "c_5.dat") * 1e9)


def test_read_only_survives_reopen_like_jax(two_volumes):
    vols, dirs, needles, _ = two_volumes
    for k, mod in (("port", volume), ("ref", jax_volume)):
        vols[k].set_read_only(True)
        with pytest.raises(Exception, match="read-only"):
            vols[k].write_needle(needles[0])
        vols[k].close()
        vols[k] = mod.Volume(dirs[k], 5, "c", create=False)
        assert vols[k].read_only
        vols[k].set_read_only(False)
        vols[k].close()
        vols[k] = mod.Volume(dirs[k], 5, "c", create=False)
        assert not vols[k].read_only
    assert _files(dirs["port"]) == _files(dirs["ref"])


def test_torn_tail_reopen_matches_jax(two_volumes):
    """A half-written record and a half-written .idx entry at the tail, and
    one complete record the .idx never got: both reopen to the same files,
    the torn record dropped, the un-indexed one replayed."""
    vols, dirs, needles, _ = two_volumes
    extra = [Needle(id=0xABCDEF, cookie=7, data=b"replayed" * 30, append_at_ns=5),
             JaxNeedle(id=0xABCDEF, cookie=7, data=b"replayed" * 30, append_at_ns=5)]
    torn = Needle(id=0x123, cookie=9, data=b"torn" * 100, append_at_ns=6).to_bytes()
    for (k, mod), rec in zip((("port", volume), ("ref", jax_volume)), extra):
        vols[k].close()
        with open(os.path.join(dirs[k], "c_5.dat"), "ab") as f:
            f.write(rec.to_bytes())
            f.write(torn[: len(torn) // 2])
        with open(os.path.join(dirs[k], "c_5.idx"), "ab") as f:
            f.write(b"\x01" * 7)
        vols[k] = mod.Volume(dirs[k], 5, "c", create=False)
    assert _files(dirs["port"]) == _files(dirs["ref"])
    assert vols["port"].read_needle(0xABCDEF).data == b"replayed" * 30
    with pytest.raises(NotFoundError):
        vols["port"].read_needle(0x123)
    assert vols["port"].file_count() == vols["ref"].file_count()


# -- the hedged remote read ---------------------------------------------------------


@pytest.mark.parametrize("scenario", ["stall", "fail"])
def test_hedged_read_matches_jax(scenario, monkeypatch):
    """Holder A stalls past the hedge delay (or fails); holder B answers.
    Both locators return B's bytes, count the same degraded-read mode and
    forget A only when it failed."""
    monkeypatch.setenv("WEED_EC_HEDGE_MS", "20")
    data = bytes(range(256)) * 4

    def fake_read(address, vid, shard_id, offset, length):
        if address == "a:1":
            if scenario == "fail":
                raise OSError("holder a is down")
            time.sleep(0.5)
            return b"\0" * length
        return data[offset:offset + length]

    results = []
    for mod, registry in ((store_ec, stats), (jax_store_ec, jax_stats)):
        loc = mod.EcShardLocator("master:1")
        loc._cache[4] = (time.monotonic(), 1e9, {2: ["a:1", "b:1"]})
        monkeypatch.setattr(loc, "read_remote", fake_read)
        before = {m: registry.EC_DEGRADED_READS.value(mode=m) for m in ("hedge", "failover")}
        t = time.perf_counter()
        got = loc.hedged_read(4, 2, ["a:1", "b:1"], 100, 300)
        wall = time.perf_counter() - t
        modes = {m: registry.EC_DEGRADED_READS.value(mode=m) - before[m] for m in before}
        loc._pool.shutdown(wait=True)  # the stalled loser finishes
        results.append((got, modes, loc._cache[4][2][2]))
        assert wall < 0.45, wall  # B answered without waiting out A's stall
    assert results[0] == results[1]
    got, modes, holders = results[0]
    assert got == data[100:400]
    if scenario == "stall":
        assert modes == {"hedge": 1, "failover": 0} and holders == ["a:1", "b:1"]
    else:
        assert modes == {"hedge": 0, "failover": 1} and holders == ["b:1"]


class _Refused(grpc.RpcError):
    """What the stub raises for an injected or real UNAVAILABLE."""

    def code(self):
        return grpc.StatusCode.UNAVAILABLE


@pytest.mark.parametrize("breaker", ["closed", "open"])
def test_transient_refusal_keeps_the_holder(breaker, monkeypatch):
    """The only holder of a shard refuses one EcShardRead with UNAVAILABLE,
    then answers.  The JAX locator forgets it on that one failure and
    reconstructs this read and the next (ROADMAP Queue C item 6, repaired
    in the port only); the port's asks it again while its breaker is
    closed, keeps it located and reads both intervals from it.  With the
    holder's breaker already open both forget it and reconstruct."""
    data = bytes(range(256)) * 4
    out = {}
    for name, mod, res in (("port", store_ec, resilience), ("jax", jax_store_ec, jax_resilience)):
        monkeypatch.setattr(res, "breakers", res.BreakerRegistry())
        if breaker == "open":
            br = res.breakers.get("a:1")
            for _ in range(res.policy().breaker_threshold):
                br.record_failure()
        calls = []

        class FakeStub:
            def EcShardRead(self, req, timeout=None):  # noqa: N802 — the proto's name
                calls.append(req.shard_id)
                if len(calls) == 1:
                    raise _Refused()
                return iter([SimpleNamespace(is_deleted=False,
                                             data=data[req.offset:req.offset + req.size])])

        monkeypatch.setattr(mod.rpc, "volume_stub", lambda _address: FakeStub())
        loc = mod.EcShardLocator("master:1")
        loc._cache[4] = (time.monotonic(), 1e9, {2: ["a:1"]})
        monkeypatch.setattr(loc, "recover_interval", lambda _ev, _sid, _off, n: b"R" * n)
        fetch = loc.make_fetcher(None)
        out[name] = ([fetch(4, 2, 100, 300), fetch(4, 2, 100, 300)], loc._cache[4][2][2],
                     len(calls))
        loc._pool.shutdown(wait=True)
    reconstructed = ([b"R" * 300] * 2, [], 1)
    assert out["jax"] == reconstructed
    if breaker == "closed":
        assert out["port"] == ([data[100:400]] * 2, ["a:1"], 3)
    else:
        assert out["port"] == reconstructed


# -- the in-process cluster ---------------------------------------------------------


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster")
    master = MasterServer(port=0, grpc_port=0, volume_size_limit_mb=64)
    master.topology.dead_node_timeout = 3.0
    master.start()
    dirs = [str(root / f"d{i}") for i in range(N_SERVERS)]
    for d in dirs:
        os.makedirs(d)
    # the volumes the tests encode, written before their servers start so
    # the servers load them and heartbeat them
    vols = {1: write_needle_volume(dirs[0], seed=11, n=400, vid=1),
            3: write_needle_volume(dirs[2], seed=13, n=200, vid=3)}
    vols[2] = write_needle_volume(dirs[1], seed=12, n=300, vid=2)
    for ext in (".dat", ".idx"):
        os.rename(os.path.join(dirs[1], "2" + ext), os.path.join(dirs[1], "lrc_2" + ext))
    ref = root / "ref"
    for vid, d, name in ((1, dirs[0], "1"), (2, dirs[1], "lrc_2"), (3, dirs[2], "3")):
        os.makedirs(ref / str(vid))
        shutil.copy(os.path.join(d, name + ".dat"), ref / str(vid) / "v.dat")
    shas = {vid: _sha(ref / str(vid) / "v.dat") for vid in vols}
    servers = []
    for i, d in enumerate(dirs):
        vs = VolumeServer([d], master.grpc_address, port=0, grpc_port=0, rack=f"rack{i % 2}",
                          heartbeat_interval=0.2, device="cpu")
        vs.start()
        servers.append(vs)
    _wait(lambda: len(master.topology.nodes) == N_SERVERS, "4 registered servers")
    _wait(lambda: all(master.topology.lookup(v) for v in vols), "the volumes at the master")
    yield dict(master=master, servers=servers, vols=vols, ref=ref, shas=shas)
    for vs in servers:
        vs.stop()
    master.stop()


def _ref_shards(cluster, vid: int, scheme) -> dict[int, str]:
    """sha256 of every shard of the JAX package's write_ec_files of the
    volume's .dat."""
    base = str(cluster["ref"] / str(vid) / "v")
    if not os.path.exists(base + ".ec00"):
        jax_ec_encoder.write_ec_files(base, scheme)
    return {sid: _sha(base + f".ec{sid:02d}") for sid in range(scheme.total_shards)}


def _shards(cluster, vid: int, collection: str = "") -> dict[int, list[tuple[int, str]]]:
    """sid -> [(server index, sha256)] of the mounted shards on disk."""
    out: dict[int, list] = {}
    for i, vs in enumerate(cluster["servers"]):
        ev = vs.store.find_ec_volume(vid)
        for sid in (ev.shard_ids() if ev is not None else []):
            out.setdefault(sid, []).append((i, _sha(f"{ev.base}.ec{sid:02d}")))
    return out


def _master_counts(master, vid: int) -> dict[str, int]:
    return {n.id: ShardBits(n.ec_shards.get(vid, 0)).count()
            for n in master.topology.nodes.values()}


def _master_view_is_disk(master, servers, vid: int) -> bool:
    """The master's shard map of ``vid`` names, for every server, exactly
    the shards mounted there.  A count alone can read 14 while the
    master still holds the generating server's pre-balance view (its
    heartbeat deltas for the moved shards not yet in)."""
    disk = {vs.url: sorted(ev.shard_ids()) for vs in servers
            if (ev := vs.store.find_ec_volume(vid)) is not None}
    view = {n.id: ShardBits(n.ec_shards.get(vid, 0)).ids()
            for n in list(master.topology.nodes.values())}
    return {k: sorted(v) for k, v in view.items() if v} == disk


def _shell(env, line: str, runner=run_command) -> str:
    out = io.StringIO()
    runner(env, line, out)
    return out.getvalue()


def test_jax_shell_drives_the_port_servers(cluster):
    """Wire compatibility: the JAX package's shell (its CommandEnv, rpc
    layer and commands) encodes and rebuilds through the port's master and
    volume servers."""
    master = cluster["master"]
    env = JaxCommandEnv(master.grpc_address, client_name="jax-shell")
    try:
        _shell(env, "lock", jax_run_command)
        text = _shell(env, "ec.encode -volumeId 3", jax_run_command)
        assert "ec.encode volume 3 -> RS(10,4)" in text and "ec.balance moved" in text
        _wait(lambda: sum(_master_counts(master, 3).values()) == 14, "14 shards of volume 3")
        want = _ref_shards(cluster, 3, JAX_RS)
        got = _shards(cluster, 3)
        assert {sid: [h for _, h in v] for sid, v in got.items()} == {s: [h] for s, h in want.items()}
        victim = max(range(N_SERVERS), key=lambda i: sum(1 for v in got.values() if v[0][0] == i))
        lost = [sid for sid, v in got.items() if v[0][0] == victim]
        vs = cluster["servers"][victim]
        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb

        stub = rpc.volume_stub(f"{vs.ip}:{vs.grpc_port}")
        stub.EcShardsUnmount(vs_pb.EcShardsUnmountRequest(volume_id=3, shard_ids=lost), timeout=30)
        stub.EcShardsDelete(vs_pb.EcShardsDeleteRequest(volume_id=3, shard_ids=lost), timeout=30)
        _wait(lambda: sum(_master_counts(master, 3).values()) == 14 - len(lost), "the deletion")
        assert "rebuilt shards" in _shell(env, "ec.rebuild -volumeId 3", jax_run_command)
        _wait(lambda: sum(_master_counts(master, 3).values()) == 14, "the rebuild")
        got = _shards(cluster, 3)
        assert {sid: [h for _, h in v] for sid, v in got.items()} == {s: [h] for s, h in want.items()}
    finally:
        _shell(env, "unlock", jax_run_command)


def test_lrc_single_loss_stages_only_its_local_group(cluster):
    master = cluster["master"]
    env = CommandEnv(master.grpc_address)
    try:
        _shell(env, "lock")
        text = _shell(env, "ec.encode -volumeId 2 -collection lrc -code lrc")
        assert "ec.encode volume 2 -> LRC(10,2,2)" in text
        _wait(lambda: sum(_master_counts(master, 2).values()) == 14, "14 LRC shards")
        # the rebuild plans from the master's map: wait until it is the
        # servers' own, not the generating server's pre-balance view
        _wait(lambda: _master_view_is_disk(master, cluster["servers"], 2),
              "the master's shard map to match the mounted shards")
        assert master.topology.ec_schemes[2] == (10, 4, 2)
        want = _ref_shards(cluster, 2, jax_make_scheme(10, 4, 2))
        got = _shards(cluster, 2)
        assert {sid: [h for _, h in v] for sid, v in got.items()} == {s: [h] for s, h in want.items()}
        holder = cluster["servers"][got[3][0][0]]
        from seaweedfs_tpu_torch import rpc
        from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb

        rpc.volume_stub(f"{holder.ip}:{holder.grpc_port}").EcShardsDelete(
            vs_pb.EcShardsDeleteRequest(volume_id=2, collection="lrc", shard_ids=[3]), timeout=30)
        _wait(lambda: sum(_master_counts(master, 2).values()) == 13, "the deletion of shard 3")
        _wait(lambda: _master_view_is_disk(master, cluster["servers"], 2),
              "the master's shard map after the deletion")
        key = (("code", "lrc"), ("dir", "moved"), ("mode", "move"))
        before = stats.REPAIR_BYTES.series().get(key, 0.0)
        text = _shell(env, "ec.rebuild -volumeId 2")
        assert "rebuilt shards [3]" in text
        moved = stats.REPAIR_BYTES.series().get(key, 0.0) - before
        shard_size = os.path.getsize(cluster["ref"] / "2" / "v.ec00")
        # the staging copies carry only shard 3's group (0, 1, 2, 4, 10),
        # and only those the rebuilder lacked: never the 10 of a global plan
        assert 0 < moved <= 5 * shard_size, (moved, shard_size)
        _wait(lambda: sum(_master_counts(master, 2).values()) == 14, "the rebuilt shard")
        got = _shards(cluster, 2)
        assert got[3][0][1] == want[3]
    finally:
        _shell(env, "unlock")


def _read_all(ev, locator, vol, every: int = 1) -> None:
    """Every ``every``-th live needle (in id order) equals its payload;
    every tombstoned one raises NotFoundError."""
    fetch = locator.make_fetcher(ev)
    for nid, payload in sorted(vol["live"].items())[::every]:
        assert ev.read_needle(nid, fetcher=fetch).data == payload, hex(nid)
    for nid in vol["dead"]:
        with pytest.raises(NotFoundError):
            ev.read_needle(nid, fetcher=fetch)


def test_encode_remote_reads_node_loss_rebuild_decode(cluster, monkeypatch):
    master, servers, vol = cluster["master"], cluster["servers"], cluster["vols"][1]
    env = CommandEnv(master.grpc_address)
    _shell(env, "lock")
    try:
        text = _shell(env, "ec.encode -volumeId 1")
        assert "ec.encode volume 1 -> RS(10,4)" in text
        _wait(lambda: sum(_master_counts(master, 1).values()) == 14, "14 shards at the master")
        _wait(lambda: not master.topology.lookup(1), "the original volume gone at the master")
        assert not any(vs.store.find_volume(1) for vs in servers)
        assert not os.path.exists(os.path.join(servers[0].store.locations[0].directory, "1.dat"))
        want = _ref_shards(cluster, 1, JAX_RS)
        got = _shards(cluster, 1)
        assert {sid: [h for _, h in v] for sid, v in got.items()} == {s: [h] for s, h in want.items()}
        # the rack spread of tests/test_shell.py: every node holds some,
        # none holds all; and no node more than the parity count
        per_node = {i: sum(1 for v in got.values() if v[0][0] == i) for i in range(N_SERVERS)}
        assert all(0 < c <= 4 for c in per_node.values()), per_node
        per_rack = [sum(c for i, c in per_node.items() if i % 2 == r) for r in (0, 1)]
        assert per_rack == [7, 7], per_rack

        # remote reads: the shards of a server that lacks shard 0 mounted
        # here (this small volume's needles all lie in shard 0's first
        # block), the rest fetched from their holders; nothing is
        # reconstructed
        owner0 = got[0][0][0]
        reader = max((i for i in per_node if i != owner0), key=per_node.get)
        rs = servers[reader]
        store = Store([rs.store.locations[0].directory])
        store.mount_ec_shards("", 1, rs.store.find_ec_volume(1).shard_ids())
        ev = store.find_ec_volume(1)
        locator = EcShardLocator(master.grpc_address, f"{rs.ip}:{rs.grpc_port}")
        remote = [0]
        read_remote = locator.read_remote

        def counted(*a):
            out = read_remote(*a)
            remote[0] += 1
            return out

        monkeypatch.setattr(locator, "read_remote", counted)
        rec0 = stats.EC_DEGRADED_READS.value(mode="reconstruct")
        try:
            _read_all(ev, locator, vol)
            assert remote[0] > 0
            assert stats.EC_DEGRADED_READS.value(mode="reconstruct") == rec0

            # lose the holder of shard 0: its intervals are reconstructed
            victim = owner0
            lost = sorted(sid for sid, v in got.items() if v[0][0] == victim)
            servers[victim].stop()
            _wait(lambda: len(master.topology.nodes) == N_SERVERS - 1, "the lost node pruned")
            locator._cache.clear()
            _read_all(ev, locator, vol, every=4)  # each read decodes from 13 remote reads
            assert stats.EC_DEGRADED_READS.value(mode="reconstruct") > rec0
        finally:
            locator.close()
            store.close()

        text = _shell(env, "ec.rebuild -volumeId 1")
        assert f"rebuilt shards {lost}" in text
        _wait(lambda: sum(_master_counts(master, 1).values()) == 14, "14 shards after the rebuild")
        got = {sid: v for sid, v in _shards(cluster, 1).items()}
        assert {sid: [h for _, h in v] for sid, v in got.items()} == {s: [h] for s, h in want.items()}
        rebuilder = got[lost[0]][0][0]
        left = sorted(n for n in os.listdir(servers[rebuilder].store.locations[0].directory)
                      if re.fullmatch(r"1\.ec\d\d", n))
        assert left == [f"1.ec{sid:02d}" for sid, v in sorted(got.items())
                        if v[0][0] == rebuilder], left  # the temp copies are gone

        text = _shell(env, "ec.decode -volumeId 1")
        assert "ec.decode volume 1 -> normal volume" in text
        _wait(lambda: len(master.topology.lookup(1)) == 1, "the decoded volume at the master")
        _wait(lambda: sum(_master_counts(master, 1).values()) == 0, "the EC shards gone")
        holder = next(vs for vs in servers if vs.store.find_volume(1))
        assert _sha(holder.store.find_volume(1).base + ".dat") == cluster["shas"][1]
        v = holder.store.find_volume(1)
        for nid, payload in sorted(vol["live"].items()):
            assert v.read_needle(nid).data == payload
    finally:
        _shell(env, "unlock")
