"""The port's storage backends and tier (storage/backend.py: MmapDiskFile,
MemoryFile, LocalObjectStoreClient, TieredFile; storage/volume.py
tier_upload / tier_download / the tiered open / the in-memory vacuum;
storage/store.py's loader), the ``VolumeTierMove`` RPC, the
``volume.tier.upload`` / ``volume.tier.download`` shell commands and the
``volume.tier.local`` and ``backup`` commands, held against the JAX
package: each package opens the other's tiered, mmap and memory volumes;
the port's loader finds a volume the JAX package tiered (a ``.vif`` with
no ``.dat``); the RPC, the shells and the CLIs answer and print as the
JAX ones do, each shell driving the other package's servers; and a
5-byte-offset volume's ``.idx`` and ``.ecx`` are the JAX package's bytes.
Every server runs in process on port 0 and stops in ``finally``."""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import grpc
import numpy as np
import pytest

from seaweedfs_tpu import cli as jax_cli
from seaweedfs_tpu.server import master_server as jax_ms
from seaweedfs_tpu.server import volume_server as jax_vs
from seaweedfs_tpu.shell import run_command as jax_run_command
from seaweedfs_tpu.shell.command_env import CommandEnv as JaxCommandEnv
from seaweedfs_tpu.storage import backend as jax_backend
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec_encoder
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.needle import NeedleError as JaxNeedleError
from seaweedfs_tpu.storage.volume_info import VolumeInfo as JaxVolumeInfo
from seaweedfs_tpu.storage.volume_info import save_volume_info as jax_save_volume_info
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.pb import volume_server_pb2 as vs_pb
from seaweedfs_tpu_torch.server import master_server, volume_server
from seaweedfs_tpu_torch.shell import run_command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv
from seaweedfs_tpu_torch.storage import backend, store, volume
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError
from seaweedfs_tpu_torch.storage.volume_info import maybe_load_volume_info

from test_torch_volume_server import Aborted, Context
from test_torch_write_path import _http, _start_cluster, _stop_cluster, _wait

PKG = {"port": (volume, backend, Needle, NeedleError),
       "jax": (jax_volume, jax_backend, JaxNeedle, JaxNeedleError)}


@pytest.fixture
def pinned_clock(monkeypatch):
    now = [1_700_000_000_000_000_000]
    monkeypatch.setattr(time, "time_ns", lambda: now[0])
    return now


def _fill(vol, needle_cls, seed: int, n: int, clock=None) -> dict[int, bytes]:
    rng = np.random.default_rng(seed)
    live = {}
    for i in range(n):
        if clock is not None:
            clock[0] += 1000
        n_ = needle_cls(id=i + 1, cookie=i, data=rng.bytes(int(rng.integers(100, 3000))))
        vol.write_needle(n_)
        live[n_.id] = n_.data
    return live


def _reads(vol, live: dict[int, bytes]) -> bool:
    return all(vol.read_needle(k).data == d for k, d in live.items())


def _files(directory) -> dict[str, bytes]:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory)) if not name.endswith(".ldb")}


# -- the tier on one volume -----------------------------------------------------------


@pytest.mark.parametrize("uploader,downloader", [("port", "jax"), ("jax", "port")])
def test_tier_round_trip_across_packages(tmp_path, uploader, downloader):
    """One package tiers a sealed mmap volume to a directory store, the
    other opens it tiered (reads through TieredFile, writes and vacuum
    refused) and downloads it back to the byte."""
    up, up_backend, up_needle, up_err = PKG[uploader]
    down, down_backend, _needle, down_err = PKG[downloader]
    vdir, obj = tmp_path / "v", str(tmp_path / "obj")
    vdir.mkdir()
    vol = up.Volume(vdir, 7, "c", backend_kind="mmap")
    live = _fill(vol, up_needle, seed=3, n=120)
    dat = open(vdir / "c_7.dat", "rb").read()
    client = up_backend.LocalObjectStoreClient(obj)
    with pytest.raises(up_err, match="volume 7: tier requires readonly"):
        vol.tier_upload(client)
    vol.set_read_only(True)
    assert vol.tier_upload(client) == "vol/c/7.dat"
    assert not (vdir / "c_7.dat").exists()
    assert maybe_load_volume_info(vdir / "c_7.vif").remote == {
        "backend": "local", "key": "vol/c/7.dat", "root": obj, "fileSize": len(dat)}
    assert vol.tiered and _reads(vol, live)
    with pytest.raises(up_err, match="volume 7 is read-only"):
        vol.write_needle(up_needle(id=999, cookie=1, data=b"x"))
    with pytest.raises(up_err, match="volume 7 is tiered"):
        vol.vacuum()
    with pytest.raises(up_err, match="volume 7 already tiered"):
        vol.tier_upload(client)
    vol.close()

    other = down.Volume(vdir, 7, "c", create=False, backend_kind="mmap")
    assert (other.tiered, other.read_only, other.dat_size()) == (True, True, len(dat))
    assert other.file_count() == len(live) and _reads(other, live)
    other.tier_download(down_backend.LocalObjectStoreClient(obj))
    assert open(vdir / "c_7.dat", "rb").read() == dat and os.listdir(obj) == []
    assert not other.tiered and _reads(other, live)  # now through the mmap backend
    with pytest.raises(down_err, match="volume 7 is not tiered"):
        other.tier_download(down_backend.LocalObjectStoreClient(obj))
    other.close()
    again = up.Volume(vdir, 7, "c", create=False)
    assert (again.tiered, again.read_only) == (False, True)  # the seal stays
    again.close()


def test_tiered_file_blocks_and_cache(tmp_path):
    """Ranged reads across 1 MiB blocks, past the end, and the 32-block
    cache (oldest out first), as the JAX TieredFile reads."""
    rng = np.random.default_rng(0)
    blob = rng.bytes(40 * 1024 * 1024 + 123)
    (tmp_path / "src").write_bytes(blob)
    files = {}
    for name, mod in (("port", backend), ("jax", jax_backend)):
        client = mod.LocalObjectStoreClient(str(tmp_path / name))
        client.put("a/b.dat", str(tmp_path / "src"))
        assert os.listdir(tmp_path / name) == ["a_b.dat"]
        files[name] = mod.TieredFile(client, "a/b.dat")
    for off, n in ((0, 10), (1024 * 1024 - 5, 10), (3 * 1024 * 1024, 5 * 1024 * 1024),
                   (len(blob) - 7, 100), (len(blob) + 5, 10)):
        got = files["port"].read_at(off, n)
        assert got == blob[off:off + n] == files["jax"].read_at(off, n)
    for i in range(40):
        files["port"].read_at(i * 1024 * 1024, 1)
    assert len(files["port"]._cache) == 32 and min(files["port"]._cache) == 8
    assert files["port"].size() == len(blob)
    with pytest.raises(IOError, match="tiered volume a/b.dat is sealed"):
        files["port"].append(b"x")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mmap_volumes_open_across_packages(tmp_path, pinned_clock, writer):
    """mmap volumes are the disk layout: the same writes leave the same
    bytes in both packages, each reopens the other's, a reopened map
    follows growth, a torn tail is truncated under the map, and the map
    after a vacuum is the compacted file's."""
    for name, (mod, _b, needle_cls, _e) in PKG.items():
        pinned_clock[0] = 1_700_000_000_000_000_000
        (tmp_path / name).mkdir()
        vol = mod.Volume(tmp_path / name, 3, backend_kind="mmap")
        live = _fill(vol, needle_cls, seed=6, n=80, clock=pinned_clock)
        vol.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    reader = "jax" if writer == "port" else "port"
    mod, _b, needle_cls, _e = PKG[reader]
    d = tmp_path / writer
    with open(d / "3.dat", "ab") as f:
        f.write(b"\x07" * 13)  # a torn tail: a header-sized scrap
    vol = mod.Volume(d, 3, create=False, backend_kind="mmap")
    assert vol.dat_size() % 8 == 0 and _reads(vol, live)
    vol.write_needle(needle_cls(id=500, cookie=5, data=b"grown" * 999))
    assert vol.read_needle(500).data == b"grown" * 999  # past the first map
    for k in list(live)[::2]:
        vol.delete_needle(k)
        live.pop(k)
    assert vol.vacuum() > 0
    assert _reads(vol, live) and vol.read_needle(500).data == b"grown" * 999
    vol.close()


def test_memory_volume_vacuum_matches_jax(tmp_path, pinned_clock):
    """RAM-backed volumes: the same writes, deletes and in-memory vacuum
    in both packages reclaim the same bytes and leave the same .idx; a
    memory volume refuses an on-disk .dat."""
    out = {}
    for name, (mod, _b, needle_cls, _e) in PKG.items():
        pinned_clock[0] = 1_700_000_000_000_000_000
        d = tmp_path / name
        d.mkdir()
        vol = mod.Volume(d, 5, backend_kind="memory", needle_map_kind="compact")
        live = _fill(vol, needle_cls, seed=8, n=100, clock=pinned_clock)
        for k in list(live)[::5] + list(live)[1::5]:
            vol.delete_needle(k)
            live.pop(k)
        before = vol.dat_size()
        reclaimed = vol.vacuum()
        assert not (d / "5.dat").exists() and _reads(vol, live)
        with pytest.raises(KeyError):
            vol.read_needle(1)
        out[name] = (before, reclaimed, vol.dat_size(), vol.file_count(), vol.garbage_ratio(),
                     vol.super_block.compaction_revision)
        vol.close()
        (d / "5.dat").write_bytes(b"\x00" * 8)
        with pytest.raises(ValueError, match="volume 5: memory backend cannot open on-disk .dat"):
            mod.Volume(d, 5, backend_kind="memory")
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0 and out["port"][1] + out["port"][2] == out["port"][0]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


# -- the loader repair --------------------------------------------------------------


def test_port_loader_finds_a_jax_tiered_volume(tmp_path):
    """A JAX volume sealed and tier_uploaded leaves a .vif and no .dat: the
    port's loader opens it (it found none before), reports it in the
    heartbeat as the JAX Store does, and skips an EC volume's .vif, which
    names no object.  Deleting the volume drops its object."""
    d, obj = tmp_path / "d", str(tmp_path / "obj")
    d.mkdir()
    vol = jax_volume.Volume(d, 7)
    live = _fill(vol, JaxNeedle, seed=1, n=40)
    vol.set_read_only(True)
    vol.tier_upload(jax_backend.LocalObjectStoreClient(obj))
    vol.close()
    jax_save_volume_info(str(d / "9.vif"), JaxVolumeInfo(version=3))  # an EC volume's
    loc = store.DiskLocation(d)
    loc.load_existing_volumes()
    assert sorted(loc.volumes) == [7]
    jax_loc = jax_store.DiskLocation(str(d))
    jax_loc.load_existing_volumes()
    assert sorted(jax_loc.volumes) == [7]
    assert _reads(loc.volumes[7], live)
    jax_loc.close()
    loc.close()
    stats = {}
    for name, mod in (("port", store), ("jax", jax_store)):
        s = mod.Store([str(d)], needle_map_kind="leveldb")
        s.load_existing_volumes()
        stats[name] = s.volume_stats()
        s.close()
    assert stats["port"] == stats["jax"] and stats["port"][0]["read_only"]
    s = store.Store([str(d)])
    s.load_existing_volumes()
    s.delete_volume(7)
    assert os.listdir(obj) == [] and sorted(os.listdir(d)) == ["9.vif"]


# -- VolumeTierMove -----------------------------------------------------------------


def test_volume_tier_move_answers_as_jax(tmp_path):
    """The port's servicer and the JAX one on copies of one volume: the
    same codes, messages, keys and errors, and the same files after."""
    src = tmp_path / "src"
    src.mkdir()
    vol = volume.Volume(src, 4, "t")
    _fill(vol, Needle, seed=2, n=30)
    vol.close()
    dirs = {k: tmp_path / k for k in ("port", "jax")}
    for d in dirs.values():
        shutil.copytree(src, d)
    port_vs = volume_server.VolumeServer([str(dirs["port"])], device="cpu")
    ref_vs = jax_vs.VolumeServer([str(dirs["jax"])], "127.0.0.1:1")
    servicers = {"port": volume_server.VolumeServerGrpcServicer(port_vs),
                 "jax": jax_vs.VolumeServerGrpcServicer(ref_vs)}
    try:
        def both(**kw):
            out = {}
            for name, s in servicers.items():
                req = vs_pb.VolumeTierMoveRequest(dest=str(tmp_path / f"obj-{name}"), **kw)
                try:
                    out[name] = ("ok", s.volume_tier_move(req, Context()).key)
                except Aborted as e:
                    out[name] = ("aborted", e.code, e.details)
                except (NeedleError, JaxNeedleError) as e:
                    out[name] = ("raised", str(e))
            assert out["port"] == out["jax"], kw
            return out["port"]

        assert both(volume_id=9) == ("aborted", grpc.StatusCode.NOT_FOUND, "volume 9 not found")
        assert both(volume_id=4) == ("aborted", grpc.StatusCode.FAILED_PRECONDITION,
                                     "volume 4 is not sealed readonly")
        assert both(volume_id=4, download=True) == ("raised", "volume 4 is not tiered")
        assert both(volume_id=4, force_seal=True) == ("ok", "vol/t/4.dat")
        assert both(volume_id=4, force_seal=True) == ("raised", "volume 4 already tiered")
        assert both(volume_id=4, download=True) == ("ok", "")
    finally:
        port_vs.store.close()
        ref_vs.store.close()
    assert _files(dirs["port"]) == _files(dirs["jax"])


# -- the shells against both packages' clusters ----------------------------------------


@pytest.fixture(scope="module")
def clusters():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SEAWEEDFS_TPU_NATIVE_DP", "0")
        mp.setenv("WEED_SCRUB_INTERVAL", "0")
        made = {}
        try:
            made["port"] = _start_cluster(master_server, volume_server, device="cpu")
            made["jax"] = _start_cluster(jax_ms, jax_vs)
            yield made
        finally:
            for c in made.values():
                _stop_cluster(c)


def _fill_cluster(c, collection: str, n: int) -> dict[str, bytes]:
    """n needles into ``collection``: {fid: payload} of one volume."""
    a = c.assign(f"?collection={collection}&count={n}")
    out = {}
    for i in range(n):
        fid = a["fid"] if i == 0 else f"{a['fid']}_{i}"
        out[fid] = np.random.default_rng(i).bytes(700 + 53 * i)
        assert _http(a["url"], "POST", f"/{fid}", out[fid])[0] == 201
    return out


def _shell(shell: str, c, line: str) -> str:
    if shell == "port":
        runner, env = run_command, CommandEnv(c.master.grpc_address)
    else:
        runner, env = jax_run_command, JaxCommandEnv(c.master.grpc_address, client_name="tier")
    out = io.StringIO()
    runner(env, "lock", out)
    try:
        runner(env, line, out)
    finally:
        runner(env, "unlock", out)
    return out.getvalue()


@pytest.mark.parametrize("shell,target", [("jax", "port"), ("port", "port"), ("port", "jax")])
def test_tier_upload_and_download_through_the_shells(clusters, tmp_path, shell, target):
    """volume.tier.upload / download through one package's shell against
    the other's (or its own) servers: an unsealed volume is refused, -force
    seals and tiers it, reads go on through the object store while writes
    are refused, the master sees the seal, and the download restores the
    .dat byte for byte."""
    c = clusters[target]
    needles = _fill_cluster(c, f"tier{shell}{target}", 12)
    vid = int(next(iter(needles)).split(",")[0])
    (holder,) = c.holders(vid)
    node, dest = holder.url, str(tmp_path / "obj")
    dat_path = holder.store.find_volume(vid).base + ".dat"
    dat = open(dat_path, "rb").read()
    with pytest.raises(grpc.RpcError) as refused:
        _shell(shell, c, f"volume.tier.upload -node {node} -volumeId {vid} "
                         f"-collection tier{shell}{target} -dest {dest}")
    assert refused.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    assert refused.value.details() == f"volume {vid} is not sealed readonly"
    out = _shell(shell, c, f"volume.tier.upload -node {node} -volumeId {vid} "
                           f"-collection tier{shell}{target} -dest {dest} -force")
    assert out == (f"lock acquired\nvolume {vid} tiered to {dest} as "
                   f"vol/tier{shell}{target}/{vid}.dat\nlock released\n")
    assert not os.path.exists(dat_path)
    for fid, data in needles.items():
        assert _http(holder.url, "GET", f"/{fid}") == (200, data)
    assert _http(holder.url, "POST", f"/{fid[:-2]}99", b"late")[0] == 500
    _wait(lambda: c.master.topology.nodes[holder.url].volumes[vid].read_only,
          "the master's view of the seal")
    out = _shell(shell, c, f"volume.tier.download -node {node} -volumeId {vid} -dest {dest}")
    assert out == f"lock acquired\nvolume {vid} downloaded from {dest}\nlock released\n"
    assert open(dat_path, "rb").read() == dat and os.listdir(dest) == []
    for fid, data in needles.items():
        assert _http(holder.url, "GET", f"/{fid}") == (200, data)


# -- the CLIs -----------------------------------------------------------------------


def test_cli_volume_tier_local_prints_what_the_jax_cli_prints(tmp_path, capsys):
    (tmp_path / "src").mkdir()
    vol = volume.Volume(tmp_path / "src", 6)
    _fill(vol, Needle, seed=4, n=20)
    vol.close()
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        d, obj = tmp_path / name, tmp_path / f"obj-{name}"
        shutil.copytree(tmp_path / "src", d)
        with pytest.raises(SystemExit, match="volume 6 is not sealed readonly; seal it first"):
            main(["volume.tier.local", "upload", "-dir", str(d), "-volumeId", "6",
                  "-dest", str(obj)])
        capsys.readouterr()
        assert main(["volume.tier.local", "upload", "-dir", str(d), "-volumeId", "6",
                     "-dest", str(obj), "-force"]) == 0
        up = capsys.readouterr().out.replace(str(obj), "OBJ")
        assert sorted(os.listdir(d)) == ["6.idx", "6.vif"]
        assert main(["volume.tier.local", "download", "-dir", str(d), "-volumeId", "6",
                     "-dest", str(obj)]) == 0
        out[name] = (up, capsys.readouterr().out.replace(str(d), "DIR"), _files(d))
    assert out["port"] == out["jax"]
    assert out["port"][:2] == ("volume 6 tiered to OBJ as vol/default/6.dat\n",
                               "volume 6 downloaded back to DIR\n")


def test_cli_backup_lands_the_holders_files(clusters, tmp_path, capsys):
    """``cli backup`` of both packages against the port's cluster: the
    holder's .dat and .idx, byte for byte, and the same report line."""
    c = clusters["port"]
    needles = _fill_cluster(c, "bk", 9)
    vid = int(next(iter(needles)).split(",")[0])
    (holder,) = c.holders(vid)
    base = holder.store.find_volume(vid).base
    out = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        dest = tmp_path / name
        assert main(["backup", "-master", c.master.grpc_address, "-volumeId", str(vid),
                     "-collection", "bk", "-dir", str(dest)]) == 0
        out[name] = capsys.readouterr().out.replace(str(dest), "DEST")
        for ext in (".dat", ".idx"):
            assert open(f"{dest}/bk_{vid}{ext}", "rb").read() == open(base + ext, "rb").read()
        assert not [p for p in os.listdir(dest) if p.endswith(".tmp")]
    assert out["port"] == out["jax"]
    assert out["port"].startswith(f"backed up volume {vid} from {holder.url} to DEST/bk_{vid}")
    backup = volume.Volume(tmp_path / "port", vid, "bk", create=False)
    assert backup.file_count() == len(needles)
    backup.close()
    with pytest.raises(SystemExit, match="volume 4242: "):
        cli.main(["backup", "-master", c.master.grpc_address, "-volumeId", "4242",
                  "-dir", str(tmp_path / "none")])


# -- 5-byte offsets ----------------------------------------------------------------


def test_offset_width_5_idx_and_ecx_equal_jax(tmp_path, pinned_clock):
    """A width-5 volume (the store's -offsetWidth 5) writes 17-byte .idx
    entries; its .idx and the .ecx that ec.encode sorts from it are the
    JAX package's bytes."""
    s = store.Store([str(tmp_path / "port")], offset_width=5)
    pinned_clock[0] = 1_700_000_000_000_000_000
    vol = s.add_volume(2, "w5")
    assert vol.offset_width == 5
    (tmp_path / "jax").mkdir()
    jax_vol = jax_volume.Volume(tmp_path / "jax", 2, "w5", offset_width=5)
    for v, cls in ((vol, Needle), (jax_vol, JaxNeedle)):
        pinned_clock[0] = 1_700_000_000_000_000_000
        live = _fill(v, cls, seed=12, n=50, clock=pinned_clock)
        for k in list(live)[::4]:
            v.delete_needle(k)
        v.close()
    assert os.path.getsize(tmp_path / "port" / "w5_2.idx") == (50 + 13) * 17
    ec_encoder.write_sorted_ecx_file(str(tmp_path / "port" / "w5_2"), offset_width=5)
    jax_ec_encoder.write_sorted_ecx_file(str(tmp_path / "jax" / "w5_2"), offset_width=5)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files["w5_2.ecx"]) == (50 - 13) * 17
    again = volume.Volume(tmp_path / "port", 2, "w5", create=False)
    assert again.offset_width == 5 and again.file_count() == 37
    again.close()
