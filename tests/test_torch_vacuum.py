"""The port's volume compaction (storage/volume.py vacuum, scan,
rebuild_index, the .cpt crash recovery, set_replica_placement) and its
auto-vacuum loop (storage/vacuum.py), held against the JAX package's on
the same seeded volumes: byte-identical .dat and .idx after a vacuum, the
same reclaimed bytes and garbage ratios, and each package recovering the
other's volume left in the vacuum's swap window."""

from __future__ import annotations

import os
import shutil
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.storage import vacuum, volume
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.types import get_actual_size

MODS = {"port": (volume, Needle), "ref": (jax_volume, JaxNeedle)}
WAIT_S = 30.0


def _files(directory) -> dict[str, bytes]:
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def _needle(cls, rng, i: int):
    return cls(id=int(rng.integers(1, 1 << 40)), cookie=int(rng.integers(0, 1 << 32)),
               data=rng.bytes(int(rng.integers(1, 4000))) + bytes([i % 251]))


def _fill(vol, cls, seed: int, n: int, delete_every: int, overwrite_every: int, now) -> list:
    """n seeded needles, every delete_every-th deleted, every
    overwrite_every-th overwritten; returns the live (id, cookie, data)."""
    rng = np.random.default_rng(seed)
    needles = [_needle(cls, rng, i) for i in range(n)]
    for n_ in needles:
        now[0] += 1000
        vol.write_needle(n_)
    live = {n_.id: n_ for n_ in needles}
    for i in range(0, n, delete_every):
        vol.delete_needle(needles[i].id)
        live.pop(needles[i].id)
    for i in range(1, n, overwrite_every):
        now[0] += 1000
        needles[i].data = b"overwritten-%d" % i
        vol.write_needle(needles[i])
        live[needles[i].id] = needles[i]  # a deleted needle comes back
    return [(n_.id, n_.cookie, n_.data) for n_ in live.values()]


@pytest.fixture
def pinned_clock(monkeypatch):
    now = [1_700_000_000_000_000_000]
    monkeypatch.setattr(time, "time_ns", lambda: now[0])
    return now


@pytest.fixture
def pair(tmp_path, pinned_clock):
    """The same seeded volume (40% of its needles deleted, some
    overwritten) written through the port's and the JAX Volume."""
    dirs = {k: tmp_path / k for k in MODS}
    vols, live = {}, {}
    for k, (mod, cls) in MODS.items():
        dirs[k].mkdir()
        vols[k] = mod.Volume(dirs[k], 7, "c", replica_placement="001")
        pinned_clock[0] = 1_700_000_000_000_000_000
        live[k] = _fill(vols[k], cls, seed=3, n=500, delete_every=5, overwrite_every=7,
                        now=pinned_clock)
    assert live["port"] == live["ref"]
    state = dict(vols=vols, dirs=dirs, live=live["port"])
    yield state
    for v in state["vols"].values():  # the volumes the test left open
        v.close()


def _corrupt_live_record(vol, key: int) -> None:
    nv = vol.nm.get(key)
    with open(vol.base + ".dat", "r+b") as f:
        f.seek(nv.offset + 16 + 3)  # a data byte: the CRC no longer matches
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("corrupt", [0, 3])
def test_vacuum_is_byte_identical_to_jax(pair, corrupt):
    vols, dirs, live = pair["vols"], pair["dirs"], pair["live"]
    dropped = [key for key, _c, _d in live[:corrupt]]
    for key in dropped:
        for v in vols.values():
            _corrupt_live_record(v, key)
    for name in ("deleted_bytes", "garbage_ratio", "dat_size", "file_count"):
        assert getattr(vols["port"], name)() == getattr(vols["ref"], name)(), name
    assert vols["port"].garbage_ratio() > 0.3
    before = {k: v.dat_size() for k, v in vols.items()}
    garbage = vols["port"].deleted_bytes() + sum(
        get_actual_size(vols["port"].nm.get(key).size, vols["port"].version) for key in dropped)
    port_corrupt = stats.DISK_CORRUPTION.value(path="vacuum")
    ref_corrupt = jax_stats.DISK_CORRUPTION.value(path="vacuum")
    reclaimed = {k: v.vacuum() for k, v in vols.items()}
    assert reclaimed["port"] == reclaimed["ref"] == before["port"] - vols["port"].dat_size()
    # exactly the dead records, the tombstones and the dropped corrupt ones
    assert reclaimed["port"] == garbage
    assert stats.DISK_CORRUPTION.value(path="vacuum") - port_corrupt == len(dropped)
    assert jax_stats.DISK_CORRUPTION.value(path="vacuum") - ref_corrupt == len(dropped)
    for k, v in vols.items():
        assert v.super_block.compaction_revision == 1, k
        assert v.garbage_ratio() == 0.0 and v.deleted_bytes() == 0
        assert v.file_count() == len(live) - len(dropped)
        v.close()
    pair["vols"] = {}
    assert _files(dirs["port"]) == _files(dirs["ref"])
    assert sorted(_files(dirs["port"])) == ["c_7.dat", "c_7.idx"]
    reopened = {k: MODS[k][0].Volume(dirs[k], 7, "c", create=False) for k in MODS}
    pair["vols"] = reopened
    for key, cookie, data in live:
        if key in dropped:
            with pytest.raises(volume.NotFoundError):
                reopened["port"].read_needle(key)
            continue
        assert reopened["port"].read_needle(key, cookie).data == data
        assert reopened["ref"].read_needle(key, cookie).data == data
    assert str(reopened["port"].super_block.replica_placement) == "001"


def test_garbage_ratio_follows_deletes_and_overwrites_like_jax(tmp_path, pinned_clock):
    for k in MODS:
        (tmp_path / k).mkdir()
    vols = {k: mod.Volume(tmp_path / k, 1) for k, (mod, _cls) in MODS.items()}
    rng = np.random.default_rng(5)
    seq = [(int(rng.integers(1, 60)), int(rng.integers(0, 3)), rng.bytes(int(rng.integers(1, 900))))
           for _ in range(300)]
    try:
        for key, op, data in seq:
            pinned_clock[0] += 1000
            got = []
            for k, (_mod, cls) in MODS.items():
                if op == 0:
                    got.append(vols[k].delete_needle(key))
                else:
                    got.append(vols[k].write_needle(cls(id=key, cookie=1, data=data)))
                got.append((vols[k].deleted_bytes(), vols[k].garbage_ratio()))
            assert got[:2] == got[2:]
        for k, (mod, _cls) in MODS.items():  # the ratio survives a reopen
            ratio = vols[k].garbage_ratio()
            vols[k].close()
            vols[k] = mod.Volume(tmp_path / k, 1, create=False)
            assert vols[k].garbage_ratio() == pytest.approx(ratio)
    finally:
        for v in vols.values():
            v.close()


@pytest.mark.parametrize("vacuumed_by", ["port", "ref"])
@pytest.mark.parametrize("opened_by", ["port", "ref"])
def test_swap_window_crash_recovers_like_jax(pair, tmp_path, vacuumed_by, opened_by):
    """A crash between the vacuum's two renames: a compacted .dat, the
    stale pre-vacuum .idx and the .cpt marker.  Each package opens the
    volume either package left so, rebuilds the index from the .dat and
    drops the marker; both end with the same .idx."""
    vols, dirs, live = pair["vols"], pair["dirs"], pair["live"]
    src = dirs[vacuumed_by]
    stale_idx = open(os.path.join(src, "c_7.idx"), "rb").read()
    vols[vacuumed_by].vacuum()
    for v in vols.values():
        v.close()
    pair["vols"] = {}
    crashed = {}
    for k in MODS:  # one copy of the crashed volume for each package
        crashed[k] = tmp_path / f"crash_{k}"
        crashed[k].mkdir()
        shutil.copy(os.path.join(src, "c_7.dat"), crashed[k] / "c_7.dat")
        (crashed[k] / "c_7.idx").write_bytes(stale_idx)
        (crashed[k] / "c_7.cpt").write_bytes(b"")
        (crashed[k] / "c_7.cpd").write_bytes(b"half a compaction")
    opened = {k: MODS[k][0].Volume(crashed[k], 7, "c", create=False) for k in MODS}
    for v in opened.values():
        v.close()
    assert _files(crashed["port"]) == _files(crashed["ref"])
    assert sorted(_files(crashed["port"])) == ["c_7.dat", "c_7.idx"]
    v = MODS[opened_by][0].Volume(crashed[opened_by], 7, "c", create=False)
    pair["vols"] = {opened_by: v}
    assert v.file_count() == len(live)
    for key, cookie, data in live:
        assert v.read_needle(key, cookie).data == data


@pytest.mark.parametrize("vacuumed_by", ["port", "ref"])
def test_each_package_opens_the_others_compacted_volume(pair, vacuumed_by):
    vols, dirs, live = pair["vols"], pair["dirs"], pair["live"]
    vols[vacuumed_by].vacuum()
    vols[vacuumed_by].close()
    other = "ref" if vacuumed_by == "port" else "port"
    v = MODS[other][0].Volume(dirs[vacuumed_by], 7, "c", create=False)
    vols[vacuumed_by] = v  # closed by the fixture
    assert v.super_block.compaction_revision == 1 and v.garbage_ratio() == 0.0
    for key, cookie, data in live:
        assert v.read_needle(key, cookie).data == data
    v.vacuum()  # and compacts it again: revision 2, nothing to reclaim
    assert v.super_block.compaction_revision == 2


def test_rebuild_index_and_scan_match_jax(pair):
    """`weed fix`: the index rebuilt from the .dat (a corrupt record
    skipped and counted) is the JAX package's, byte for byte."""
    vols, dirs, live = pair["vols"], pair["dirs"], pair["live"]
    key = next(k for k, _c, d in live if not d.startswith(b"overwritten"))  # one record only
    for v in vols.values():
        _corrupt_live_record(v, key)
    scans = {k: [(off, n.id, n.size) for off, n in v.scan(verify_crc=True)]
             for k, v in vols.items()}
    assert scans["port"] == scans["ref"]
    assert vols["port"].nm.get(key).offset not in {off for off, _i, _s in scans["port"]}
    before = stats.DISK_CORRUPTION.value(path="scan")
    for v in vols.values():
        v.rebuild_index()
    assert stats.DISK_CORRUPTION.value(path="scan") - before == 1
    assert vols["port"].file_count() == vols["ref"].file_count() == len(live) - 1
    for v in vols.values():
        v.close()
    pair["vols"] = {}
    assert _files(dirs["port"]) == _files(dirs["ref"])


def test_set_replica_placement_matches_jax(pair):
    vols, dirs = pair["vols"], pair["dirs"]
    for v in vols.values():
        v.set_replica_placement("010")
        assert str(v.super_block.replica_placement) == "010"
        with pytest.raises(ValueError):
            v.set_replica_placement("x")
    for v in vols.values():
        v.close()
    pair["vols"] = {}
    assert _files(dirs["port"]) == _files(dirs["ref"])


# -- auto-vacuum (the JAX tests/test_auto_vacuum.py cases, on both) -----------------


def _stores_with_garbage(tmp_path, now, deletes: dict[int, int]) -> dict:
    """{package: Store} over one directory each, holding volumes whose
    deletes are given per vid (20 writes of 1000 bytes each)."""
    stores = {}
    for k, (mod, cls) in MODS.items():
        d = tmp_path / k
        d.mkdir()
        now[0] = 1_700_000_000_000_000_000
        for vid, n_del in deletes.items():
            vol = mod.Volume(d, vid)
            for i in range(20):
                now[0] += 1000
                vol.write_needle(cls(id=i, cookie=1, data=bytes([i % 251]) * 1000))
            for i in range(n_del):
                vol.delete_needle(i)
            vol.close()
        stores[k] = (Store if k == "port" else JaxStore)([str(d)])
        stores[k].load_existing_volumes()
    return stores


def test_auto_vacuum_pass_compacts_over_threshold_only(tmp_path, pinned_clock):
    stores = _stores_with_garbage(tmp_path, pinned_clock, {1: 12, 2: 1})
    try:
        results, loops = {}, {}
        for k, st in stores.items():
            av = loops[k] = (vacuum if k == "port" else jax_vacuum).AutoVacuum(
                st, interval_s=0, garbage_threshold=0.3)
            results[k] = av.vacuum_pass()
            snap = av.snapshot()
            assert snap["passes"] == 1 and snap["volumes_vacuumed"] == 1
            assert snap["reclaimed_bytes"] == results[k][0]["reclaimed"]
        assert results["port"] == results["ref"]
        assert [r["vid"] for r in results["port"]] == [1]
        for k, st in stores.items():
            assert st.find_volume(1).garbage_ratio() == 0.0
            assert st.find_volume(2).super_block.compaction_revision == 0
            for i in range(12, 20):
                assert st.find_volume(1).read_needle(i).data == bytes([i % 251]) * 1000
        assert loops["port"].snapshot() in vacuum.snapshot()  # /debug/vacuum sees the loop
    finally:
        for st in stores.values():
            st.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_auto_vacuum_background_loop_and_heartbeat_hook(tmp_path, pinned_clock, monkeypatch):
    stores = _stores_with_garbage(tmp_path, pinned_clock, {1: 12})
    monkeypatch.setenv("WEED_VACUUM_INTERVAL_S", "0.05")
    try:
        done = []
        av = vacuum.AutoVacuum(stores["port"], on_volume_done=done.append)
        assert (av.interval_s, av.garbage_threshold) == (0.05, 0.3)  # the env knobs
        av.start()
        deadline = time.monotonic() + WAIT_S
        while not done and time.monotonic() < deadline:
            time.sleep(0.05)
        av.stop()
        assert done and done[0].id == 1
        assert stores["port"].find_volume(1).garbage_ratio() == 0.0
        monkeypatch.delenv("WEED_VACUUM_INTERVAL_S")
        idle = vacuum.AutoVacuum(stores["port"])
        idle.start()  # interval 0 by default: no thread
        assert idle._thread is None
    finally:
        for st in stores.values():
            st.close()


def test_reads_during_vacuums_never_fail(tmp_path):
    """Readers take no lock: one that overlaps a vacuum's file swap (the
    old .dat closed, the index and the file of different generations) is
    re-read from the new files.  The JAX package's read path fails such a
    read (ValueError on the closed file, or a record of the wrong
    generation); the port repairs it."""
    import threading

    vol = volume.Volume(tmp_path, 1)
    rng = np.random.default_rng(9)
    payloads = {}
    for key in range(1, 301):
        payloads[key] = rng.bytes(int(rng.integers(100, 3000)))
        vol.write_needle(Needle(id=key, cookie=key, data=payloads[key]))
    for key in range(1, 301, 3):
        vol.delete_needle(key)
        payloads.pop(key)
    keys = sorted(payloads)
    errors, reads, stop = [], [0], threading.Event()

    def reader(seed: int) -> None:
        r = np.random.default_rng(seed)
        while not stop.is_set():
            key = keys[int(r.integers(0, len(keys)))]
            try:
                assert vol.read_needle(key, key).data == payloads[key]
                reads[0] += 1
            except Exception as e:  # noqa: BLE001 — every failed read is the finding
                errors.append(repr(e))

    threads = [threading.Thread(target=reader, args=(i,), daemon=True) for i in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for _ in range(20):
            vol.vacuum()
            vol.rebuild_index()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=WAIT_S)
        sys.setswitchinterval(old)
        vol.close()
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:5]
    assert reads[0] > 0
    assert vol.super_block.compaction_revision == 20
