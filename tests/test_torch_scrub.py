"""The port's scrubber (storage/scrub.py) held against the JAX package's:
the same volumes and EC shards with the same bytes flipped give the same
result dicts and the same repaired bytes, for a replica repair, an
unrepairable needle, and an EC interval repair (RS and LRC, by the local
plan and through EcShardLocator); then on a port cluster, a corrupt
replica found by the read path and healed on the next tick, and
``volume.scrub`` through the port's and the JAX shell (a plain volume and
an EC volume)."""

from __future__ import annotations

import io
import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.stats import events as jax_events
from seaweedfs_tpu.server import store_ec as jax_store_ec
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.storage import scrub as jax_scrub
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.erasure_coding import ec_volume as jax_ec_volume
from seaweedfs_tpu.storage.erasure_coding import lrc as jax_lrc
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, store_ec, volume_server
from seaweedfs_tpu_torch.stats import events
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.storage import scrub, store, volume
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding import ec_volume
from seaweedfs_tpu_torch.storage.erasure_coding import lrc
from seaweedfs_tpu_torch.storage.needle import CrcMismatch, new_needle
from seaweedfs_tpu_torch.storage.types import get_actual_size
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

from test_torch_write_path import _http, _start_cluster, _stop_cluster
from test_torch_write_path import _wait as _wait_with

WAIT_S = 30.0  # each poll's deadline


def _wait(predicate, what: str) -> None:
    _wait_with(predicate, what, WAIT_S)


PKG = {
    "port": dict(volume=volume, store=store, scrub=scrub, ev=ec_volume, locator=store_ec,
                 lrc=lrc),
    "ref": dict(volume=jax_volume, store=jax_store, scrub=jax_scrub, ev=jax_ec_volume,
                locator=jax_store_ec, lrc=jax_lrc),
}


def _payload(key: int) -> bytes:
    return np.random.default_rng(1000 + key).bytes(200 + key * 37 % 900)


def _flip_byte(path: str, offset: int, mask: int = 0x20) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_volume(directory, vid: int = 1, n: int = 30) -> None:
    v = volume.Volume(directory, vid)
    for key in range(1, n + 1):
        v.write_needle(new_needle(key, key, _payload(key)))
    v.close()


def _replica_fetcher_from(replica):
    """The scrubber's repair source, served from a local Volume (what
    fetch_replica_record does over gRPC in a server)."""

    def fetch(vid, collection, key, size):
        nv = replica.nm.get(key)
        if nv is None:
            return None
        return replica._pread(nv.offset, get_actual_size(nv.size, replica.version))

    return fetch


@pytest.fixture
def replicated(tmp_path):
    """One volume's files, copied into a primary and a replica directory
    for each package."""
    src = tmp_path / "src"
    src.mkdir()
    _write_volume(src)
    dirs = {}
    for k in PKG:
        for role in ("primary", "replica"):
            d = tmp_path / f"{k}_{role}"
            shutil.copytree(src, d)
            dirs[k, role] = d
    return dirs


@pytest.mark.parametrize("case", ["repair", "sealed", "no_replica", "clean"])
def test_volume_scrub_matches_jax(replicated, case):
    flips = {"repair": [7, 19], "sealed": [3], "no_replica": [11], "clean": []}[case]
    results, opened = {}, []
    try:
        for k, mods in PKG.items():
            st = mods["store"].Store([str(replicated[k, "primary"])])
            st.load_existing_volumes()
            replica = mods["volume"].Volume(replicated[k, "replica"], 1, create=False)
            opened += [st, replica]
            vol = st.find_volume(1)
            if case == "sealed":
                vol.set_read_only(True)
            for key in flips:
                _flip_byte(vol.base + ".dat", vol.nm.get(key).offset + 40)
            if flips:
                with pytest.raises(Exception) as e:
                    vol.read_needle(flips[0])
                assert "crc" in type(e.value).__name__.lower()
            done = []
            s = mods["scrub"].VolumeScrubber(
                st, interval_s=0, on_volume_done=done.append,
                replica_fetcher=None if case == "no_replica" else _replica_fetcher_from(replica))
            results[k] = s.scrub_volume(vol)
            assert done == [vol] and vol.last_scrub_at_ns > 0
            assert vol.scrub_corrupt == results[k]["failed"]
            if case != "no_replica":
                for key in flips:
                    assert vol.read_needle(key).data == _payload(key)
                # the in-place restore lands the replica's record bytes exactly
                assert _read(vol.base + ".dat") == _read(replica.base + ".dat")
            assert s.snapshot()["volumes"] == {1: results[k]}
    finally:
        for o in opened:
            o.close()
    assert results["port"] == results["ref"]
    want = {"repair": (2, 2, 0), "sealed": (1, 1, 0), "no_replica": (1, 0, 1), "clean": (0, 0, 0)}
    assert (results["port"]["corrupt"], results["port"]["repaired"],
            results["port"]["failed"]) == want[case]
    assert results["port"]["scanned"] == 30
    assert _read(replicated["port", "primary"] / "1.dat") == _read(
        replicated["ref", "primary"] / "1.dat")
    # the flight recorder holds one finding per corrupt needle, and one
    # repair per repaired one, as the JAX package's does
    for ring in (events.default_ring, jax_events.default_ring):
        found = ring.to_dicts(events.SCRUB_CORRUPTION, limit=len(flips)) if flips else []
        assert [(e["volume"], e["needle"], e["ec"]) for e in found] == [
            (1, format(k, "x"), False) for k in flips]
        if case in ("repair", "sealed"):
            fixed = ring.to_dicts(events.SCRUB_REPAIRED, limit=len(flips))
            assert [(e["needle"], e["source"]) for e in fixed] == [
                (format(k, "x"), "replica") for k in flips]


def test_event_ring_matches_jax():
    for mod, st in ((events, stats), (jax_events, jax_stats)):
        assert mod.KINDS == events.KINDS
        ring = mod.EventRing(capacity=16)
        dropped = st.EVENTS_DROPPED.value()
        for i in range(20):
            ring.record(mod.SCRUB_REPAIRED, volume=i, needle="a", source="replica")
        assert st.EVENTS_DROPPED.value() - dropped == 4  # displaced before being read
        rows = ring.to_dicts()
        assert [r["seq"] for r in rows] == list(range(5, 21)) and rows[0]["volume"] == 4
        assert [r["volume"] for r in ring.to_dicts(limit=3)] == [17, 18, 19]
        assert ring.to_dicts(mod.SCRUB_CORRUPTION) == []
        with pytest.raises(ValueError, match="unregistered"):
            ring.record("scrub.bogus")
        with pytest.raises(ValueError, match="shadow"):
            ring.record(mod.SCRUB_REPAIRED, seq=1)
        assert mod.EventRing(capacity=1).capacity == 16


def test_flagged_needle_is_repaired_on_the_next_tick(replicated):
    st = store.Store([str(replicated["port", "primary"])])
    st.load_existing_volumes()
    replica = volume.Volume(replicated["port", "replica"], 1, create=False)
    s = scrub.VolumeScrubber(st, interval_s=0, replica_fetcher=_replica_fetcher_from(replica))
    try:
        vol = st.find_volume(1)
        _flip_byte(vol.base + ".dat", vol.nm.get(5).offset + 30)
        with pytest.raises(CrcMismatch):
            vol.read_needle(5)
        s.start()
        for _ in range(50):  # a hot corrupt needle is one repair, not fifty
            s.flag(1, 5)
        _wait(lambda: vol.read_needle(5).data == _payload(5) if _ok(vol, 5) else False,
              "the flagged needle repaired")
        assert s.snapshot()["flagged_pending"] == 0
        assert s.snapshot() in scrub.snapshot()  # /debug/scrub sees the scrubber
    finally:
        s.stop()
        replica.close()
        st.close()
    assert s._thread is None


def _ok(vol, key) -> bool:
    try:
        vol.read_needle(key)
        return True
    except CrcMismatch:
        return False


# -- EC interval repair -----------------------------------------------------------


def _ec_dirs(tmp_path, local_groups: int) -> dict:
    """One needle volume EC-encoded with small blocks (RS(10,4) or
    LRC(10,2,2)), its files copied once for each package."""
    src = tmp_path / "ec_src"
    src.mkdir()
    _write_volume(src, n=39)
    base = str(src / "1")
    scheme = lrc.make_scheme(10, 4, local_groups, large_block_size=10000, small_block_size=100)
    ec_encoder.write_ec_files(base, scheme, chunk=10000, device="cpu")
    ec_encoder.write_sorted_ecx_file(base)
    save_volume_info(base + ".vif", VolumeInfo(version=3, dat_file_size=os.path.getsize(base + ".dat"),
                                               data_shards=10, parity_shards=4,
                                               local_groups=local_groups))
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    out = {}
    for k in PKG:
        out[k] = tmp_path / f"ec_{k}"
        shutil.copytree(src, out[k])
    return out


@pytest.mark.parametrize("local_groups", [0, 2], ids=["rs", "lrc"])
@pytest.mark.parametrize("route", ["local_plan", "locator"])
def test_ec_interval_repair_matches_jax(tmp_path, local_groups, route):
    dirs = _ec_dirs(tmp_path, local_groups)
    results, healed, repair_read = {}, {}, {}
    for k, mods in PKG.items():
        scheme = mods["lrc"].make_scheme(10, 4, local_groups, large_block_size=10000,
                                         small_block_size=100)
        ev = mods["ev"].EcVolume(dirs[k], 1, scheme=scheme)
        for sid in range(14):
            ev.add_shard(sid)
        st = mods["store"].Store([str(tmp_path / f"unused_{k}")])
        locator = mods["locator"].EcShardLocator("") if route == "locator" else None
        try:
            _off, _size, intervals = ev.locate(5)
            sid, shard_off = intervals[0].to_shard_and_offset(ev.scheme)
            path = ev.shards[sid].path
            good = _read(path)
            _flip_byte(path, shard_off + 20)
            with pytest.raises(Exception) as e:
                ev.read_needle(5)
            assert "crc" in type(e.value).__name__.lower()
            before = (stats if k == "port" else jax_stats).REPAIR_BYTES
            read0 = sum(v for key, v in before.series().items() if ("dir", "read") in key)
            s = mods["scrub"].VolumeScrubber(st, interval_s=0, ec_locator=locator)
            results[k] = s.scrub_ec_volume(ev)
            repair_read[k] = sum(v for key, v in before.series().items()
                                 if ("dir", "read") in key) - read0
            healed[k] = _read(path) == good
            assert ev.read_needle(5).data == _payload(5)
            assert results[k] == s.snapshot()["volumes"][1]
        finally:
            ev.close()
            st.close()
            if k == "port" and locator is not None:
                locator.close()  # the port's locator owns a thread pool
    assert results["port"] == results["ref"]
    assert results["port"]["ec"] and results["port"]["failed"] == 0
    assert results["port"]["corrupt"] >= 1 and results["port"]["scanned"] == 39
    assert healed == {"port": True, "ref": True}  # the shard file itself, byte-exact
    assert repair_read["port"] == repair_read["ref"] > 0
    for name in sorted(os.listdir(dirs["port"])):
        assert _read(dirs["port"] / name) == _read(dirs["ref"] / name), name


class _OwnerLocator:
    """A holder's view of one shard it does not hold: its intervals are read
    from the owner's file, and the owner rewrites the corrupt byte right
    after this holder's ``rewrite_after``-th read of it."""

    def __init__(self, path: str, offset: int, good: bytes, rewrite_after: int):
        self.path, self.offset, self.good = path, offset, good
        self.rewrite_after = rewrite_after
        self.reads = 0
        self.fresh_lookups = 0

    def make_fetcher(self, ev):
        def fetch(vid: int, shard_id: int, offset: int, length: int) -> bytes:
            with open(self.path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
            if offset <= self.offset < offset + length:
                self.reads += 1
                if self.reads == self.rewrite_after:
                    with open(self.path, "r+b") as f:  # the owner's scrubber
                        f.seek(self.offset)
                        f.write(self.good)
            return data

        return fetch

    def shard_locations(self, vid: int, fresh: bool = False) -> dict:
        self.fresh_lookups += fresh
        return {}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_ec_scrub_recounts_an_interval_its_owner_rewrites(tmp_path, pkg):
    """One holder scrubs an EC volume whose needle 5 is corrupt on a shard
    another holder owns.  The owner rewrites the interval after this
    holder's first read and its repair's re-read, before the count (ROADMAP
    Queue C item 2).  The JAX scrubber counts the needle FAILED although
    the shard is whole; the port re-reads it once at the end of the pass,
    with fresh locations, and counts nothing."""
    dirs = _ec_dirs(tmp_path, 0)
    mods = PKG[pkg]
    scheme = mods["lrc"].make_scheme(10, 4, 0, large_block_size=10000, small_block_size=100)
    ev = mods["ev"].EcVolume(dirs[pkg], 1, scheme=scheme)
    _off, _size, intervals = ev.locate(5)
    sid, shard_off = intervals[0].to_shard_and_offset(ev.scheme)
    for i in range(14):
        if i != sid:
            ev.add_shard(i)
    owner = str(dirs[pkg] / f"1.ec{sid:02d}")
    with open(owner, "rb") as f:
        f.seek(shard_off + 20)
        good = f.read(1)
    _flip_byte(owner, shard_off + 20)
    locator = _OwnerLocator(owner, shard_off + 20, good, rewrite_after=2)
    st = mods["store"].Store([str(tmp_path / "unused")])
    try:
        result = mods["scrub"].VolumeScrubber(st, interval_s=0, ec_locator=locator).scrub_ec_volume(ev)
        assert ev.read_needle(5, locator.make_fetcher(ev)).data == _payload(5)
    finally:
        ev.close()
        st.close()
    counts = {k: result[k] for k in ("scanned", "corrupt", "repaired", "failed")}
    if pkg == "port":
        assert counts == dict(scanned=39, corrupt=0, repaired=0, failed=0)
        assert locator.fresh_lookups == 1
    else:
        assert counts == dict(scanned=39, corrupt=1, repaired=0, failed=1)


def test_local_reconstruction_substitutes_a_short_survivor(tmp_path):
    """A plan input that reads short is excluded and the plan recomputed
    over the spare survivors, as in the JAX package."""
    dirs = _ec_dirs(tmp_path, 0)
    got = {}
    for k, mods in PKG.items():
        scheme = mods["lrc"].make_scheme(10, 4, 0, large_block_size=10000, small_block_size=100)
        ev = mods["ev"].EcVolume(dirs[k], 1, scheme=scheme)
        for sid in range(14):
            ev.add_shard(sid)
        try:
            os.truncate(ev.shards[1].path, 50)  # shard 1 reads short past byte 50
            got[k] = mods["scrub"]._reconstruct_local(ev, 0, 100, 100)
            want = ev.shards[0].read_at(100, 100)
        finally:
            ev.close()
    assert got["port"] == got["ref"] == want


# -- on a port cluster ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    c = _start_cluster(master_server, volume_server, device="cpu", scrub_interval_s=0)
    yield c
    _stop_cluster(c)


def _put_replicated(c, data: bytes, collection: str = "scrub") -> tuple[str, list]:
    a = c.assign(f"?replication=001&collection={collection}")
    status, _ = _http(a["url"], "POST", f"/{a['fid']}", data)
    assert status == 201
    vid = int(a["fid"].split(",")[0])
    return a["fid"], c.holders(vid)


def _shell(runner, env, line: str) -> str:
    out = io.StringIO()
    for cmd in ("lock", line, "unlock"):
        runner(env, cmd, out)
    return out.getvalue()


def test_read_path_500_flags_and_the_next_tick_heals(cluster):
    data = b"scrub-e2e " * 400
    fid, holders = _put_replicated(cluster, data)
    victim = holders[0]
    vid, nid, _ = volume_server.parse_fid(fid)
    vol = victim.store.find_volume(vid)
    _flip_byte(vol.base + ".dat", vol.nm.get(nid).offset + 60)
    before = stats.DISK_CORRUPTION.value(path="read")
    assert _http(victim.url, "GET", f"/{fid}") == (500, b"crc mismatch")
    assert stats.DISK_CORRUPTION.value(path="read") == before + 1
    # the 500 flagged the needle: the scrub tick repairs it from the other
    # holder (ReadNeedleBlob through the master's lookup)
    _wait(lambda: _http(victim.url, "GET", f"/{fid}") == (200, data), "the self-healed read")
    assert stats.SCRUB_REPAIRS.value(source="replica", outcome="fixed") >= 1
    assert _read(vol.base + ".dat") == _read(holders[1].store.find_volume(vid).base + ".dat")


@pytest.mark.parametrize("shell", ["port", "jax"])
def test_volume_scrub_shell_repairs_and_reports(cluster, shell):
    data = b"shell-scrub " * 300
    fid, holders = _put_replicated(cluster, data, collection=f"scrub{shell}")
    vid, nid, _ = volume_server.parse_fid(fid)
    vol = holders[1].store.find_volume(vid)
    _flip_byte(vol.base + ".dat", vol.nm.get(nid).offset + 50)
    maddr = cluster.master.grpc_address
    runner, env = ((run_command, CommandEnv(maddr)) if shell == "port"
                   else (jax_run_command, JaxCommandEnv(maddr, client_name="scrub-suite")))
    text = _shell(runner, env, f"volume.scrub -volumeId {vid}")
    assert "1 corrupt, 1 repaired" in text
    assert "volume.scrub: 2 needles verified, 1 corrupt, 1 repaired, 0 failed" in text
    assert _http(holders[1].url, "GET", f"/{fid}") == (200, data)
    # scrub results reach the master's health view through the heartbeat
    _wait(lambda: all(n.volumes[vid].last_scrub_ns > 0 and n.volumes[vid].scrub_corrupt == 0
                      for n in cluster.master.topology.nodes.values() if vid in n.volumes),
          "the scrub stamp at the master")
    status, body = _http(holders[1].url, "GET", "/debug/scrub")
    assert status == 200 and b"volumes" in body
    clean = _shell(runner, env, f"volume.scrub -volumeId {vid} -noRepair -verbose")
    assert "1 scanned, 0 corrupt, 0 repaired" in clean and "(verify only)" in clean


def test_volume_scrub_repairs_an_ec_shard_interval_through_the_locator(cluster):
    """An EC-encoded volume on the cluster: a byte flipped in one
    holder's shard is rebuilt from the other holders' intervals
    (EcShardLocator.recover_interval) and the shard file is whole again."""
    payloads = {}
    for i in range(40):
        a = cluster.assign("?collection=ecscrub")
        payloads[a["fid"]] = np.random.default_rng(i).bytes(3000 + 97 * i)
        assert _http(a["url"], "POST", f"/{a['fid']}", payloads[a["fid"]])[0] == 201
    vid = int(next(iter(payloads)).split(",")[0])
    payloads = {f: d for f, d in payloads.items() if int(f.split(",")[0]) == vid}
    env = CommandEnv(cluster.master.grpc_address)
    _shell(run_command, env, f"ec.encode -volumeId {vid} -collection ecscrub")
    _wait(lambda: sum(len(vs.store.find_ec_volume(vid).shard_ids())
                      for vs in cluster.servers if vs.store.find_ec_volume(vid)) == 14,
          "14 mounted shards")
    fid = sorted(payloads)[0]
    _, nid, _ = volume_server.parse_fid(fid)
    holder, ev = next((vs, vs.store.find_ec_volume(vid)) for vs in cluster.servers
                      if vs.store.find_ec_volume(vid) is not None
                      and ev_holds(vs.store.find_ec_volume(vid), nid))
    _off, _size, intervals = ev.locate(nid)
    sid, shard_off = intervals[0].to_shard_and_offset(ev.scheme)
    path = ev.shards[sid].path
    good = _read(path)
    _flip_byte(path, shard_off + 10)
    out = io.StringIO()
    run_command(env, "lock", out)
    resp = env.volume(f"{holder.ip}:{holder.grpc_port}").VolumeScrub(
        vs_pb.VolumeScrubRequest(volume_id=vid, repair=True))
    run_command(env, "unlock", out)
    (r,) = resp.results
    assert (r.ec, r.corrupt, r.repaired, r.failed) == (True, 1, 1, 0)
    assert _read(path) == good
    for f, d in payloads.items():
        assert _http(holder.url, "GET", f"/{f}") == (200, d)
    text = _shell(run_command, env, f"volume.scrub -volumeId {vid}")
    assert "needles verified, 0 corrupt, 0 repaired, 0 failed" in text


def ev_holds(ev, nid: int) -> bool:
    """Whether the first interval of needle ``nid`` is on a shard ``ev``
    holds locally."""
    _off, _size, intervals = ev.locate(nid)
    return intervals[0].to_shard_and_offset(ev.scheme)[0] in ev.shards


def test_scrub_metrics_are_rendered(cluster):
    text = stats.render_text()
    for name in ("weedtpu_scrub_needles_total", "weedtpu_scrub_bytes_total",
                 "weedtpu_scrub_passes_total", "weedtpu_disk_corruption_total",
                 "weedtpu_scrub_repairs_total"):
        assert f"# TYPE {name} counter" in text, name
