"""The port's EC needle-read path against the JAX package's, on the same
files: interval geometry (``ec_locate``), ``ShardBits``, ``EcVolume``
needle reads through the local half of ``EcShardLocator`` (every needle of
a small volume, with RS and LRC shards removed), deletes with ``.ecj``
replay, and the repair counters.  Tolerance is zero: bytes must match."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import stats as jax_stats
from seaweedfs_tpu.server import store_ec as jax_store_ec
from seaweedfs_tpu.storage import store as jax_store
from seaweedfs_tpu.storage.erasure_coding import ec_locate as jax_locate
from seaweedfs_tpu.storage.erasure_coding import ec_volume as jax_ev
from seaweedfs_tpu.storage.erasure_coding import lrc as jax_lrc
from seaweedfs_tpu.storage.erasure_coding import scheme as jax_scheme
from seaweedfs_tpu.storage.erasure_coding import shard_bits as jax_bits
from seaweedfs_tpu.storage.volume import NotFoundError as JaxNotFoundError
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.server import store_ec
from seaweedfs_tpu_torch.server.store_ec import EcShardLocator
from seaweedfs_tpu_torch.storage import store
from seaweedfs_tpu_torch.storage.erasure_coding import (
    ec_encoder,
    ec_locate,
    ec_volume,
    lrc,
    shard_bits,
)
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import scheme_local_groups
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import DEFAULT_SCHEME, EcScheme
from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_NAME, Needle
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.types import Version, pack_index_entry
from seaweedfs_tpu_torch.storage.volume import NotFoundError
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

KIB = 1024

# -- small EC needle volumes (also used by test_torch_volume_server.py) ----------


def write_needle_volume(directory: str, seed: int, n: int = 400, big: int = 6,
                        dead: int = 12, vid: int = 1) -> dict:
    """``n`` needles of 1 B - 4 KiB and ``big`` of 8-40 KiB, seeded, appended
    after a version-3 superblock; ``dead`` of them tombstoned in the .idx.
    Returns {"live": {id: payload}, "dead": [ids], "dat_size": bytes}."""
    rng = np.random.default_rng(seed)
    base = os.path.join(directory, str(vid))
    sizes = list(rng.integers(1, 4097, n)) + list(rng.integers(8 << 10, 40 << 10, big))
    order = rng.permutation(len(sizes))
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 40, 2 * len(sizes)))[: len(sizes)])
    payloads = {}
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        dat.write(SuperBlock().to_bytes())
        off = dat.tell()
        for i in order:
            nid = int(ids[i])
            data = rng.bytes(int(sizes[i]))
            needle = Needle(id=nid, cookie=int(rng.integers(0, 1 << 32)), data=data,
                            append_at_ns=int(rng.integers(1, 1 << 60)))
            if i % 3 == 0:
                needle.name = f"file-{nid:x}.bin".encode()
                needle.flags |= FLAG_HAS_NAME
            record = needle.to_bytes(Version.V3)
            dat.write(record)
            idx.write(pack_index_entry(nid, off, needle.size))
            off += len(record)
            payloads[nid] = data
        dead_ids = [int(x) for x in rng.choice(sorted(payloads), dead, replace=False)]
        for nid in dead_ids:
            idx.write(pack_index_entry(nid, 0, -1))
            del payloads[nid]
    return {"live": payloads, "dead": dead_ids, "dat_size": off}


def encode_volume(directory: str, scheme, dat_size: int, vid: int = 1) -> None:
    """The EC files of the volume through the port's CPU pipeline: shards,
    sorted .ecx and a .vif recording the geometry and the .dat size."""
    base = os.path.join(directory, str(vid))
    ec_encoder.write_ec_files(base, scheme, device="cpu")
    ec_encoder.write_sorted_ecx_file(base)
    save_volume_info(base + ".vif", VolumeInfo(
        version=3, dat_file_size=dat_size, data_shards=scheme.data_shards,
        parity_shards=scheme.parity_shards, local_groups=scheme_local_groups(scheme),
        offset_width=4))


# -- interval geometry ----------------------------------------------------------

TEST_GEOMETRY = dict(data_shards=10, parity_shards=4, large_block_size=10000, small_block_size=100)
GOLDEN = [  # (geometry, shard_size, offset, size) of tests/test_ec_locate.py
    ({}, 3221225472, 21479557912, 4194339),  # 30 GB, multi-interval
    ({}, 3221225472, 30782909808, 112568),  # 30 GB, single interval
    (TEST_GEOMETRY, 10001, 10 * 10000, 1),  # start of the small area
    (TEST_GEOMETRY, 10001, 10 * 10000 - 50, 100),  # large -> small transition
    (TEST_GEOMETRY, 20001, 0, 2 * 10 * 10000 + 250),  # every large block, then small ones
]


def _ivs(intervals) -> list[tuple]:
    return [(iv.block_index, iv.inner_offset, iv.size, iv.is_large_block, iv.large_block_rows)
            for iv in intervals]


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_locate_data_golden_vectors_match_jax(case):
    geo, shard_size, offset, size = GOLDEN[case]
    port_scheme, ref_scheme = EcScheme(**geo), jax_scheme.EcScheme(**geo)
    got = ec_locate.locate_data(port_scheme, shard_size, offset, size)
    want = jax_locate.locate_data(ref_scheme, shard_size, offset, size)
    assert _ivs(got) == _ivs(want)
    assert sum(iv.size for iv in got) == size
    assert [iv.to_shard_and_offset(port_scheme) for iv in got] == \
        [iv.to_shard_and_offset(ref_scheme) for iv in want]
    if case == 0:
        assert got[0] == ec_locate.Interval(4, 527128, 521448, False, 2)


@pytest.mark.parametrize("geometry", [{}, TEST_GEOMETRY,
                                      dict(data_shards=6, parity_shards=3,
                                           large_block_size=8 * KIB, small_block_size=KIB)])
def test_locate_data_matches_jax_on_seeded_ranges(geometry):
    rng = np.random.default_rng(len(geometry))
    port_scheme, ref_scheme = EcScheme(**geometry), jax_scheme.EcScheme(**geometry)
    large, k = port_scheme.large_block_size, port_scheme.data_shards
    for _ in range(300):
        shard_size = int(rng.integers(1, 4 * large + 2))
        dat_size = shard_size * k
        offset = int(rng.integers(0, dat_size))
        size = int(rng.integers(1, min(dat_size - offset, 40 * port_scheme.small_block_size) + 1))
        got = ec_locate.locate_data(port_scheme, shard_size, offset, size)
        want = jax_locate.locate_data(ref_scheme, shard_size, offset, size)
        assert _ivs(got) == _ivs(want), (shard_size, offset, size)
        assert [iv.to_shard_and_offset(port_scheme) for iv in got] == \
            [iv.to_shard_and_offset(ref_scheme) for iv in want]


# -- ShardBits ------------------------------------------------------------------


def test_shard_bits_match_jax():
    rng = np.random.default_rng(7)
    port_lrc, ref_lrc = lrc.make_scheme(10, 4, 2), jax_lrc.make_scheme(10, 4, 2)
    for _ in range(200):
        ids = [int(i) for i in rng.choice(14, int(rng.integers(0, 15)), replace=False)]
        other = int(rng.integers(0, 1 << 14))
        p, j = shard_bits.ShardBits(0), jax_bits.ShardBits(0)
        for sid in ids:
            p, j = p.add(sid), j.add(sid)
        assert int(p) == int(j) and p.ids() == j.ids() and p.count() == j.count()
        assert [p.index_of(s) for s in range(14)] == [j.index_of(s) for s in range(14)]
        assert [p.has(s) for s in range(14)] == [j.has(s) for s in range(14)]
        assert int(p.plus(other)) == int(j.plus(other))
        assert int(p.minus(other)) == int(j.minus(other))
        if ids:
            assert int(p.remove(ids[0])) == int(j.remove(ids[0]))
        assert p.group_counts(port_lrc) == j.group_counts(ref_lrc)
        assert p.group_counts(DEFAULT_SCHEME) == {} == j.group_counts(jax_scheme.DEFAULT_SCHEME)
        for g in range(2):
            assert p.missing_group_members(port_lrc, g) == j.missing_group_members(ref_lrc, g)
    assert [port_lrc.group_shard_bits(g) for g in range(2)] == \
        [ref_lrc.group_shard_bits(g) for g in range(2)]


# -- needle reads ---------------------------------------------------------------

SCHEMES = {  # name -> (port scheme, JAX scheme)
    "rs": (EcScheme(10, 4, small_block_size=KIB),
           jax_scheme.EcScheme(10, 4, small_block_size=KIB)),
    "rs_large": (EcScheme(10, 4, large_block_size=32 * KIB, small_block_size=KIB),
                 jax_scheme.EcScheme(10, 4, large_block_size=32 * KIB, small_block_size=KIB)),
    "lrc": (lrc.LrcScheme(10, 4, small_block_size=KIB, local_groups=2),
            jax_lrc.LrcScheme(10, 4, small_block_size=KIB, local_groups=2)),
}


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """One needle volume, EC-encoded once per scheme."""
    root = tmp_path_factory.mktemp("ec_read")
    src = root / "src"
    src.mkdir()
    vol = write_needle_volume(str(src), seed=11)
    dirs = {}
    for name, (port_scheme, _ref) in SCHEMES.items():
        d = root / name
        shutil.copytree(src, d)
        encode_volume(str(d), port_scheme, vol["dat_size"])
        dirs[name] = str(d)
    return vol, dirs


def _mounted(directory, scheme, module, lost):
    ev = module.EcVolume(directory, 1, scheme=scheme)
    for sid in range(scheme.total_shards):
        if sid not in lost:
            ev.add_shard(sid)
    return ev


def _counters(module) -> tuple[dict, dict]:
    return (dict(module.REPAIR_BYTES.series()),
            {k: v for k, v in module.EC_OPS.series().items() if k == (("op", "reconstruct"),)})


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


STATES = [("rs", ()), ("rs", (3,)), ("rs", (0, 11)), ("rs", (1, 5, 12)), ("rs", (0, 3, 10, 13)),
          ("lrc", (3,)), ("lrc", (3, 7)), ("lrc", (0, 5, 12, 13)), ("lrc", (0, 1, 10, 11)),
          ("rs_large", ()), ("rs_large", (0, 3, 10, 13))]


@pytest.mark.parametrize("name,lost", STATES, ids=[f"{n}-{'_'.join(map(str, l)) or 'healthy'}"
                                                   for n, l in STATES])
def test_read_every_needle_matches_jax(volumes, name, lost, monkeypatch):
    vol, dirs = volumes
    port_scheme, ref_scheme = SCHEMES[name]
    port_ev = _mounted(dirs[name], port_scheme, ec_volume, lost)
    ref_ev = _mounted(dirs[name], ref_scheme, jax_ev, lost)
    locator = EcShardLocator()
    ref_locator = jax_store_ec.EcShardLocator("")
    monkeypatch.setattr(ref_locator, "_holders", lambda vid, sid: [])
    port_fetch, ref_fetch = locator.make_fetcher(port_ev), ref_locator.make_fetcher(ref_ev)
    before, ref_before = _counters(stats), _counters(jax_stats)
    try:
        crossing, kinds = 0, set()
        for nid, payload in sorted(vol["live"].items()):
            got = port_ev.read_needle(nid, fetcher=port_fetch)
            want = ref_ev.read_needle(nid, fetcher=ref_fetch)
            assert got.data == payload, hex(nid)
            assert got.to_bytes() == want.to_bytes()
            intervals = port_ev.locate(nid)[2]
            crossing += len(intervals) > 1
            kinds |= {iv.is_large_block for iv in intervals}
        if name == "rs_large":  # needles in the large rows and in the small ones
            assert kinds == {True, False}
        else:  # many needles span 1 KiB blocks
            assert crossing > len(vol["live"]) // 3
        for nid in vol["dead"]:
            with pytest.raises(NotFoundError):
                port_ev.read_needle(nid, fetcher=port_fetch)
            with pytest.raises(JaxNotFoundError):
                ref_ev.read_needle(nid, fetcher=ref_fetch)
        port_bytes = _delta(_counters(stats)[0], before[0])
        ref_bytes = _delta(_counters(jax_stats)[0], ref_before[0])
        assert port_bytes == ref_bytes
        assert _delta(_counters(stats)[1], before[1]) == _delta(_counters(jax_stats)[1], ref_before[1])
        modes = {dict(k)["mode"] for k in port_bytes}
        if not lost:
            assert not port_bytes
        elif name == "lrc" and lost != (0, 1, 10, 11):
            # a read needs only the lost data shards, and each one's group
            # is whole even when the rebuild of {0, 5, 12, 13} is global
            assert modes == {"local"}
        elif name == "lrc":  # group 0 lacks 1 and 10: the local plan is abandoned
            assert modes == {"local", "global"}
        else:
            assert modes == {"global"}
    finally:
        locator.close()
        port_ev.close()
        ref_ev.close()


def test_lrc_local_read_reads_a_group(volumes):
    """A single-loss LRC read rebuilds from its 5 group co-members: 5 x the
    interval's length in weedtpu_repair_bytes_total{lrc,local,read}."""
    vol, dirs = volumes
    port_scheme, _ = SCHEMES["lrc"]
    ev = _mounted(dirs["lrc"], port_scheme, ec_volume, (3,))
    locator = EcShardLocator()
    key = (("code", "lrc"), ("dir", "read"), ("mode", "local"))
    try:
        before = stats.REPAIR_BYTES.series().get(key, 0.0)
        got = locator.recover_interval(ev, 3, 0, 700)
        assert stats.REPAIR_BYTES.series()[key] - before == 5 * 700
        with open(ev.base + ".ec03", "rb") as f:
            assert got == f.read(700)
    finally:
        locator.close()
        ev.close()


def test_too_few_shards_raise_not_found(volumes):
    vol, dirs = volumes
    port_scheme, _ = SCHEMES["rs"]
    ev = _mounted(dirs["rs"], port_scheme, ec_volume, (0, 1, 2, 3, 4))
    locator = EcShardLocator()
    try:
        with pytest.raises(NotFoundError, match="only 9 shards reachable, need 10"):
            locator.recover_interval(ev, 0, 0, 100)
        with pytest.raises(NotFoundError, match="not present and no fetcher"):
            ev.read_interval(ev.locate(min(vol["live"]))[2][0])
    finally:
        locator.close()
        ev.close()


def test_too_few_shards_are_unreachable_not_absent(volumes, monkeypatch):
    """Fewer than k shards answer: both packages raise a NotFoundError, the
    port's a ShardsUnreachableError, which its volume server answers with
    503 so that the client asks the next holder of the volume; the JAX
    package's a plain one, a 404 that ends the read (ROADMAP Queue C item
    6, repaired in the port only)."""
    _vol, dirs = volumes
    raised = []
    for ev_mod, loc_mod, scheme in ((ec_volume, store_ec, SCHEMES["rs"][0]),
                                    (jax_ev, jax_store_ec, SCHEMES["rs"][1])):
        ev = _mounted(dirs["rs"], scheme, ev_mod, (0, 1, 2, 3, 4))
        locator = loc_mod.EcShardLocator("")
        monkeypatch.setattr(locator, "_holders", lambda vid, sid: [])
        try:
            with pytest.raises(KeyError, match="only 9 shards reachable, need 10") as e:
                locator.recover_interval(ev, 0, 0, 100)
            raised.append(type(e.value))
        finally:
            locator._pool.shutdown(wait=True)
            ev.close()
    assert raised == [store_ec.ShardsUnreachableError, JaxNotFoundError]
    assert issubclass(store_ec.ShardsUnreachableError, NotFoundError)


def test_scheme_from_vif_matches_jax(volumes):
    _vol, dirs = volumes
    for name in ("rs", "lrc"):
        port = ec_volume.EcVolume(dirs[name], 1, scheme=None)
        ref = jax_ev.EcVolume(dirs[name], 1, scheme=None)
        try:
            assert (port.scheme.data_shards, port.scheme.parity_shards, port.scheme.code_name,
                    getattr(port.scheme, "local_groups", 0)) == \
                (ref.scheme.data_shards, ref.scheme.parity_shards, ref.scheme.code_name,
                 getattr(ref.scheme, "local_groups", 0))
            assert (port.version, port.dat_file_size, port.offset_width, port.entry_size) == \
                (ref.version, ref.dat_file_size, ref.offset_width, ref.entry_size)
        finally:
            port.close()
            ref.close()


# -- deletes and .ecj replay ----------------------------------------------------


def _copy(src: str, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


def test_delete_and_ecj_replay_match_jax(volumes, tmp_path):
    vol, dirs = volumes
    port_dir, ref_dir = _copy(dirs["rs"], tmp_path / "port"), _copy(dirs["rs"], tmp_path / "ref")
    port_scheme, ref_scheme = SCHEMES["rs"]
    victims = sorted(vol["live"])[::37] + [vol["dead"][0], 12345]  # live, tombstoned, absent
    port = _mounted(port_dir, port_scheme, ec_volume, ())
    ref = _mounted(ref_dir, ref_scheme, jax_ev, ())
    for nid in victims:
        port.delete_needle(nid)
        ref.delete_needle(nid)
    for nid in sorted(vol["live"])[::37]:
        with pytest.raises(NotFoundError):
            port.read_needle(nid)
    port.close()
    ref.close()
    for ext in (".ecx", ".ecj"):
        with open(os.path.join(port_dir, "1" + ext), "rb") as a, \
                open(os.path.join(ref_dir, "1" + ext), "rb") as b:
            assert a.read() == b.read(), ext
    # replay the journal into a fresh copy of the untouched .ecx, both ways
    for d in (port_dir, ref_dir):
        shutil.copy(os.path.join(dirs["rs"], "1.ecx"), os.path.join(d, "1.ecx"))
    ec_volume.rebuild_ecx_file(os.path.join(port_dir, "1"))
    jax_ev.rebuild_ecx_file(os.path.join(ref_dir, "1"))
    with open(os.path.join(port_dir, "1.ecx"), "rb") as a, \
            open(os.path.join(ref_dir, "1.ecx"), "rb") as b:
        got = a.read()
        assert got == b.read()
    assert not os.path.exists(os.path.join(port_dir, "1.ecj"))
    assert not os.path.exists(os.path.join(ref_dir, "1.ecj"))
    with open(os.path.join(dirs["rs"], "1.ecx"), "rb") as f:
        assert got != f.read()
    ec_volume.rebuild_ecx_file(os.path.join(port_dir, "1"))  # no journal: a no-op


# -- the store's EC half --------------------------------------------------------


def test_store_mount_unmount_destroy_match_jax(volumes, tmp_path):
    _vol, dirs = volumes
    port_dir, ref_dir = _copy(dirs["lrc"], tmp_path / "port"), _copy(dirs["lrc"], tmp_path / "ref")
    port, ref = store.Store([port_dir]), jax_store.Store([ref_dir])
    try:
        steps = [("mount", list(range(14))), ("unmount", [0, 5]), ("destroy", [12, 13]),
                 ("mount", [0]), ("destroy", list(range(14)))]
        for op, sids in steps:
            for st in (port, ref):
                if op == "mount":
                    st.mount_ec_shards("", 1, sids)
                elif op == "unmount":
                    st.unmount_ec_shards(1, sids)
                else:
                    st.destroy_ec_shards("", 1, sids)
            p, r = port.find_ec_volume(1), ref.find_ec_volume(1)
            assert (p is None) == (r is None), op
            if p is not None:
                assert p.shard_ids() == r.shard_ids()
                assert p.scheme.code_name == r.scheme.code_name == "lrc"
            assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
        assert sorted(os.listdir(port_dir)) == ["1.dat", "1.idx"]
        with pytest.raises(NotFoundError):
            port.mount_ec_shards("", 1, [0])
        with pytest.raises(JaxNotFoundError):
            ref.mount_ec_shards("", 1, [0])
    finally:
        port.close()
        ref.close()
