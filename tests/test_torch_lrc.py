"""The port's LRC storage class against the JAX package's.

Algebra (ops/lrc_matrix, storage/erasure_coding/lrc), codecs
(ops/lrc_codec: LrcTorch and LrcCuda on the CPU, where LrcCuda's wrappers
run their plain versions), the plane-resident hop and the file pipeline
are held byte for byte (tolerance 0: GF(2^8) arithmetic) against
seaweedfs_tpu's lrc_matrix, lrc.py, LrcCPU, lrc_jax, lrc_pallas (interpret
mode) and ec_encoder.  Inputs are made with numpy and random from fixed
seeds.
"""

from __future__ import annotations

import os
import random
import shutil
from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import bitslice
from seaweedfs_tpu.ops import lrc_matrix as jax_lrc_matrix
from seaweedfs_tpu.ops.lrc_codec import LrcCPU, lrc_jax, lrc_pallas
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec
from seaweedfs_tpu.storage.erasure_coding import lrc as jax_lrc
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ops import lrc_matrix, rs_cuda, rs_torch, select
from seaweedfs_tpu_torch.ops.lrc_codec import LrcCuda, LrcTorch, lrc_cuda, lrc_torch
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder, lrc
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme

BW = rs_torch.BLOCK_WORDS
GEOM = dict(data_shards=10, parity_shards=4, local_groups=2,
            large_block_size=4096, small_block_size=1024)
SCHEME = lrc.LrcScheme(**GEOM)
JAX_SCHEME = jax_lrc.LrcScheme(**GEOM)
HOP_LOST = (0, 5, 12, 13)
HOP_SETS = [(12,), (13,), (12, 13), HOP_LOST]


def _present(lost, total=14):
    return tuple(i not in lost for i in range(total))


def _loss_patterns(total=14, most=4):
    return [lost for n in range(1, most + 1) for lost in combinations(range(total), n)]


def _counts() -> tuple[int, int, int, int]:
    return (rs_cuda.launches, rs_cuda.pack_launches, rs_cuda.unpack_launches,
            rs_cuda.plane_launches)


# -- algebra -----------------------------------------------------------------


@pytest.mark.parametrize("klr", [(10, 2, 2), (6, 2, 1), (12, 3, 2), (12, 4, 2)])
def test_build_lrc_matrix_matches_jax(klr):
    np.testing.assert_array_equal(lrc_matrix.build_lrc_matrix(*klr),
                                  jax_lrc_matrix.build_lrc_matrix(*klr))
    assert not lrc_matrix.build_lrc_matrix(*klr).flags.writeable


def test_every_plan_of_up_to_4_losses_matches_jax():
    """All 1470 loss patterns of LRC(10,2,2): the same (matrix, inputs,
    mode), or both raise UnrecoverableError."""
    modes = {"local": 0, "global": 0, "unrecoverable": 0}
    patterns = _loss_patterns()
    assert len(patterns) == 1470
    for lost in patterns:
        present = _present(lost)
        try:
            want = jax_lrc_matrix.reconstruction_plan(10, 2, 2, present, lost)
        except jax_lrc_matrix.UnrecoverableError:
            with pytest.raises(lrc_matrix.UnrecoverableError, match="rank"):
                lrc_matrix.reconstruction_plan(10, 2, 2, present, lost)
            assert not lrc_matrix.recoverable(10, 2, 2, present)
            modes["unrecoverable"] += 1
            continue
        mat, inputs, mode = lrc_matrix.reconstruction_plan(10, 2, 2, present, lost)
        np.testing.assert_array_equal(mat, want[0])
        assert (inputs, mode) == want[1:], lost
        modes[mode] += 1
    assert modes == {"local": 48, "global": 1282, "unrecoverable": 140}
    assert lrc_matrix.classify_loss_patterns(10, 2, 2) == modes
    assert jax_lrc_matrix.classify_loss_patterns(10, 2, 2) == modes


def test_local_repair_and_decode_rows_match_jax():
    for target in range(12):
        got, want = lrc_matrix.local_repair_matrix(10, 2, 2, target), \
            jax_lrc_matrix.local_repair_matrix(10, 2, 2, target)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[0].tolist() == [[1] * 5]
    for sid in range(14):
        assert lrc_matrix.group_of(10, 2, sid) == jax_lrc_matrix.group_of(10, 2, sid)
    for grp in range(2):
        assert lrc_matrix.group_members(10, 2, grp) == jax_lrc_matrix.group_members(10, 2, grp)
    with pytest.raises(ValueError, match="no local group"):
        lrc_matrix.local_repair_matrix(10, 2, 2, 12)
    # the first 10 present rows are singular (group 0's parity after all of
    # group 0's data), so the scan must skip shard 10 for shard 11
    present = _present((5, 12))
    dec, chosen = lrc_matrix.select_decode_rows(10, 2, 2, present)
    want_dec, want_chosen = jax_lrc_matrix.select_decode_rows(10, 2, 2, present)
    np.testing.assert_array_equal(dec, want_dec)
    assert chosen == want_chosen == (0, 1, 2, 3, 4, 6, 7, 8, 9, 11)
    for bad, match in [((10, 3, 2), "divisible"), ((0, 2, 2), "positive"),
                       ((250, 5, 2), "256")]:
        with pytest.raises(ValueError, match=match):
            lrc_matrix.build_lrc_matrix(*bad)
    with pytest.raises(ValueError, match="targets must be missing"):
        lrc_matrix.reconstruction_plan(10, 2, 2, _present((3,)), (4,))
    with pytest.raises(ValueError, match="length"):
        lrc_matrix.reconstruction_plan(10, 2, 2, (True,) * 13, ())


@pytest.mark.parametrize("geom", [(10, 4, 2), (6, 3, 2), (12, 5, 3), (12, 6, 4)])
def test_scheme_matches_jax(geom):
    k, m, groups = geom
    got, want = lrc.LrcScheme(k, m, local_groups=groups), jax_lrc.LrcScheme(k, m, local_groups=groups)
    for attr in ("code_name", "global_parities", "group_size", "max_shards_per_disk",
                 "min_total_disks", "total_shards"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for sid in range(k + m):
        assert got.group_of(sid) == want.group_of(sid)
    for grp in range(groups):
        assert got.group_members(grp) == want.group_members(grp)
    for lost in _loss_patterns(k + m, 3):
        assert got.loss_recoverable(lost) == want.loss_recoverable(lost), lost
    assert got.shard_file_size(150_001) == want.shard_file_size(150_001)


def test_scheme_bounds_and_make_scheme_match_jax():
    from seaweedfs_tpu.storage.erasure_coding.scheme import EcScheme as JaxEcScheme

    assert lrc.DEFAULT_LRC_SCHEME.max_shards_per_disk == 3
    assert lrc.DEFAULT_LRC_SCHEME == lrc.LrcScheme(10, 4, local_groups=2)
    for k, m in [(6, 3), (6, 4), (10, 4), (12, 4)]:
        got, want = EcScheme(k, m), JaxEcScheme(k, m)
        assert (got.code_name, got.max_shards_per_disk, got.min_total_disks) == (
            want.code_name, want.max_shards_per_disk, want.min_total_disks)
        assert got.loss_recoverable((0, 1, 2)) == want.loss_recoverable((0, 1, 2))
    assert lrc.DEFAULT_LRC_SCHEME.min_total_disks == 5
    assert not lrc.DEFAULT_LRC_SCHEME.loss_recoverable((0, 1, 2, 3))
    for args in [(), (10, 4, 0), (10, 4, 2), (6, 3, 1), (0, 0, 2), (12, 4, 2, 4096, 1024)]:
        got, want = lrc.make_scheme(*args), jax_lrc.make_scheme(*args)
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)
        assert lrc.scheme_local_groups(got) == jax_lrc.scheme_local_groups(want)
    for bad in [dict(local_groups=3), dict(parity_shards=2), dict(local_groups=0)]:
        with pytest.raises(ValueError):
            lrc.LrcScheme(**{"data_shards": 10, "parity_shards": 4, **bad})


def test_repair_plan_is_the_lrc_plan():
    present = _present((3,))
    mat, inputs, mode = lrc.DEFAULT_LRC_SCHEME.repair_plan(present, (3,))
    assert (inputs, mode) == ((0, 1, 2, 4, 10), "local")
    with pytest.raises(lrc_matrix.UnrecoverableError):
        lrc.DEFAULT_LRC_SCHEME.repair_plan(_present((0, 1, 10, 13)), (0, 1, 10, 13))
    assert EcScheme().repair_plan(present, (3,))[2] == "global"


# -- codecs ------------------------------------------------------------------


def _shards(n=4096 + 3, seed=7):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (10, n), np.uint8)
    return np.concatenate([data, LrcCPU(10, 2, 2).encode(data)])


def _port_codecs():
    return [LrcTorch(10, 2, 2, device="cpu"), LrcCuda(10, 2, 2, device="cpu"),
            lrc_torch(10, 2, 2, device="cpu"), lrc_cuda(10, 2, 2, device="cpu")]


def test_encode_matches_lrc_jax_and_cpu():
    shards = _shards()
    jax_parity = lrc_jax(10, 2, 2).encode(shards[:10])
    np.testing.assert_array_equal(jax_parity, shards[10:])
    before = _counts()
    for codec in _port_codecs():
        assert (codec.data_shards, codec.parity_shards, codec.total_shards) == (10, 4, 14)
        assert (codec.local_groups, codec.global_parities) == (2, 2)
        np.testing.assert_array_equal(codec.matrix, jax_lrc_matrix.build_lrc_matrix(10, 2, 2))
        np.testing.assert_array_equal(codec.encode(shards[:10]), shards[10:])
    assert _counts() == before  # on the CPU the wrappers launch nothing
    assert type(lrc_cuda(10, 2, 2, device="cpu")) is LrcCuda
    assert type(lrc_torch(10, 2, 2, device="cpu")) is LrcTorch


@pytest.mark.parametrize("lost", [(6,), (3, 7), (11,), (0, 5, 12, 13), (3, 10, 12),
                                  (0, 5, 10, 13)],
                         ids=lambda lost: "-".join(map(str, lost)))
def test_reconstruct_matches_lrc_cpu(lost):
    shards = _shards()
    holed = [None if i in lost else shards[i] for i in range(14)]
    want = LrcCPU(10, 2, 2).reconstruct(list(holed))
    for codec in _port_codecs()[:2]:
        got = codec.reconstruct(list(holed))
        for t in lost:
            np.testing.assert_array_equal(got[t], want[t])
            np.testing.assert_array_equal(got[t], shards[t])
        # a targets-restricted rebuild keeps the cheap plan
        assert codec.recon_plan(_present(lost), lost)[2] == LrcCPU(10, 2, 2).recon_plan(
            _present(lost), lost)[2]


def test_local_plan_runs_on_the_group_alone():
    """A holed view holding only the group's co-members rebuilds the lost
    shard locally, with fewer than k shards present, as LrcCPU does."""
    shards = _shards()
    group = (0, 1, 2, 4, 10)
    holed = [shards[i] if i in group else None for i in range(14)]
    want = LrcCPU(10, 2, 2).reconstruct(list(holed), targets=(3,))[3]
    for codec in _port_codecs()[:2]:
        np.testing.assert_array_equal(codec.reconstruct(list(holed), targets=(3,))[3], want)
        with pytest.raises(ValueError, match="too few shards"):
            codec.reconstruct(list(holed))
        with pytest.raises(lrc_matrix.UnrecoverableError):
            codec.reconstruct([None if i in (0, 1, 10, 13) else shards[i] for i in range(14)])


def test_device_level_rebuild_matches_plan():
    shards = _shards(n=4096)
    codec = LrcCuda(10, 2, 2, device="cpu")
    for lost in [(3,), (3, 7), HOP_LOST]:
        _mat, inputs, _mode = codec.recon_plan(_present(lost), lost)
        out = codec.reconstruct_device(_present(lost), lost, shards[list(inputs)])
        assert out.dtype == torch.uint32 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.view(torch.uint8).numpy(), shards[list(lost)])
        with pytest.raises(ValueError, match="plan reads"):
            codec.reconstruct_device(_present(lost), lost, shards[:3])


# -- the plane-resident hop ---------------------------------------------------


def test_hop_matches_lrc_pallas_interpret():
    """LrcCuda.reconstruct_words_multi (plain versions of K3, K2, K4 on the
    CPU) against lrc_pallas in interpret mode, over the four target sets
    that share the global plan's 10 inputs, at one 128 KB block."""
    shards = _shards(n=BW * 4, seed=11)
    present = _present(HOP_LOST)
    port = LrcCuda(10, 2, 2, device="cpu")
    pallas = lrc_pallas(10, 2, 2, interpret=True)
    _mat, inputs, mode = port.recon_plan(present, HOP_LOST)
    assert (inputs, mode) == ((1, 2, 3, 4, 6, 7, 8, 9, 10, 11), "global")
    words = bitslice.bytes_to_words(np.ascontiguousarray(shards[list(inputs)]))
    before = _counts()
    got = port.reconstruct_words_multi(present, HOP_SETS, torch.from_numpy(words))
    assert _counts() == before
    want = pallas.reconstruct_words_multi(present, HOP_SETS, jnp.asarray(words))
    for ts, g, w in zip(HOP_SETS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(bitslice.words_to_bytes(g.numpy()), shards[list(ts)])


def test_hop_refuses_sets_with_other_inputs_as_lrc_pallas_does():
    """(0,) alone plans locally (inputs 1-4 and 10), not on the global
    plan's 10 inputs: both packages refuse the mix."""
    present = _present(HOP_LOST)
    words = np.zeros((10, BW), np.uint32)
    assert LrcCuda(10, 2, 2, device="cpu").recon_plan(present, (0,))[2] == "local"
    for codec in (LrcCuda(10, 2, 2, device="cpu"), lrc_pallas(10, 2, 2, interpret=True)):
        with pytest.raises(ValueError, match="same inputs"):
            codec.reconstruct_words_multi(present, [(12,), (0,)], words)


# -- file pipeline -----------------------------------------------------------


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    """A ~150 KB volume: large rows, small rows and a zero-padded tail at
    the small geometry."""
    d = tmp_path_factory.mktemp("vol")
    rng = random.Random(23)
    v = Volume(d, vid=1)
    for i in range(300):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 900)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    v.close()
    return d


def _copy(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst / "1")


def _shard_files(base: str) -> dict[str, bytes]:
    d = os.path.dirname(base)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if ".ec" in f}


def _drop(base: str, lost) -> dict[int, bytes]:
    kept = {}
    for sid in lost:
        path = base + SCHEME.shard_ext(sid)
        kept[sid] = open(path, "rb").read()
        os.remove(path)
    return kept


@pytest.mark.parametrize("chunk", [2048, 1 << 20], ids=["split-large", "batched-small"])
def test_write_ec_files_identical_to_jax(volume_dir, tmp_path, chunk):
    jb, pb = _copy(volume_dir, tmp_path / "jax"), _copy(volume_dir, tmp_path / "port")
    jax_ec.write_ec_files(jb, JAX_SCHEME, codec=LrcCPU(10, 2, 2), chunk=chunk)
    stats: dict = {}
    ec_encoder.write_ec_files(pb, SCHEME, chunk=chunk, stats=stats, device="cpu")
    assert stats["engine"] == "LrcTorch"
    assert _shard_files(pb) == _shard_files(jb) and len(_shard_files(pb)) == 14


@pytest.mark.parametrize("lost", [(3,), (3, 7), HOP_LOST, (3, 10, 12), (12, 13)],
                         ids=lambda lost: "-".join(map(str, lost)))
def test_port_rebuilds_jax_encoded_shards_with_the_jax_plan(volume_dir, tmp_path, lost):
    base = _copy(volume_dir, tmp_path / "v")
    jax_ec.write_ec_files(base, JAX_SCHEME, codec=LrcCPU(10, 2, 2))
    kept = _drop(base, lost)
    stats: dict = {}
    assert ec_encoder.rebuild_ec_files(base, SCHEME, chunk=3001, stats=stats,
                                       device="cpu") == sorted(lost)
    for sid, want in kept.items():
        assert open(base + SCHEME.shard_ext(sid), "rb").read() == want
    _drop(base, lost)
    jax_stats: dict = {}
    jax_ec.rebuild_ec_files(base, JAX_SCHEME, codec=LrcCPU(10, 2, 2), stats=jax_stats)
    for key in ("read_bytes", "written_bytes", "mode", "inputs"):
        assert stats[key] == jax_stats[key], key
    shard_size = len(kept[lost[0]])
    assert stats["read_bytes"] == len(stats["inputs"]) * shard_size
    if lost == (3,):
        assert stats["mode"] == "local" and stats["inputs"] == (0, 1, 2, 4, 10)
        assert stats["read_bytes"] == 5 * shard_size
    if lost == (3, 10, 12):  # shard 3's group parity is gone: global, 10 inputs
        assert stats["mode"] == "global" and len(stats["inputs"]) == 10


def test_jax_rebuilds_port_encoded_shards(volume_dir, tmp_path):
    base = _copy(volume_dir, tmp_path / "v")
    ec_encoder.write_ec_files(base, SCHEME, device="cpu")
    for lost in [(6,), HOP_LOST]:
        kept = _drop(base, lost)
        assert jax_ec.rebuild_ec_files(base, JAX_SCHEME, codec=LrcCPU(10, 2, 2)) == sorted(lost)
        for sid, want in kept.items():
            assert open(base + SCHEME.shard_ext(sid), "rb").read() == want


def test_local_rebuild_opens_only_the_group(volume_dir, tmp_path, monkeypatch):
    base = _copy(volume_dir, tmp_path / "v")
    ec_encoder.write_ec_files(base, SCHEME, device="cpu")
    kept = _drop(base, (7,))
    opened = []
    real_open = open

    def spy(path, mode="r", *a, **kw):
        opened.append((os.path.basename(str(path)), mode))
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr("builtins.open", spy)
    stats: dict = {}
    assert ec_encoder.rebuild_ec_files(base, SCHEME, stats=stats, device="cpu") == [7]
    monkeypatch.undo()
    assert sorted(opened) == sorted(
        [(f"1.ec{sid:02d}", "rb") for sid in (5, 6, 8, 9, 11)] + [("1.ec07", "wb")])
    assert stats["read_bytes"] == 5 * len(kept[7])
    assert open(base + ".ec07", "rb").read() == kept[7]


def test_unrecoverable_pattern_raises_before_any_file_or_launch(volume_dir, tmp_path):
    base = _copy(volume_dir, tmp_path / "v")
    ec_encoder.write_ec_files(base, SCHEME, device="cpu")
    _drop(base, (0, 1, 10, 13))
    before_files, before = sorted(os.listdir(tmp_path / "v")), _counts()
    with pytest.raises(ValueError, match="unrepairable.*rank 9") as info:
        ec_encoder.rebuild_ec_files(base, SCHEME, device="cpu")
    assert isinstance(info.value.__cause__, lrc_matrix.UnrecoverableError)
    assert sorted(os.listdir(tmp_path / "v")) == before_files
    assert _counts() == before


def test_codec_selection_for_lrc():
    codec = select.pipeline_codec_for(lrc.DEFAULT_LRC_SCHEME, device="cpu")
    assert type(codec) is LrcTorch and codec.device.type == "cpu"
    assert select.pipeline_codec_for(lrc.LrcScheme(10, 4, local_groups=2), device="cpu") is codec
    small = select.small_read_codec_for(lrc.DEFAULT_LRC_SCHEME)
    assert type(small) is LrcTorch and small.device.type == "cpu"
    six = select.pipeline_codec_for(lrc.LrcScheme(6, 3, local_groups=2), device="cpu")
    assert (six.data_shards, six.local_groups, six.global_parities) == (6, 2, 1)
