"""The port's parallel/ against seaweedfs_tpu.parallel.

The JAX side runs on the conftest's 8-device virtual CPU mesh; the port's
mesh names the one CPU device 8 times (``[cpu] * 8``), its counterpart.
Inputs come from a numpy seed and every comparison is exact (byte-equal):
GF(2^8) and GF(2) arithmetic has no rounding.  On the CPU the port runs
its plain versions (the K1 table apply and the plain bit-matrix apply);
chip_smoke.py phase 6 holds the kernels on the card.
"""

from __future__ import annotations

import hashlib
import os
import random
import shutil
from itertools import combinations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from seaweedfs_tpu.parallel import distributed_ec as jax_dec
from seaweedfs_tpu.parallel import gf2 as jax_gf2
from seaweedfs_tpu.parallel import make_mesh as jax_make_mesh
from seaweedfs_tpu.storage.erasure_coding import ec_encoder as jax_ec
from seaweedfs_tpu.storage.erasure_coding.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.storage.needle import new_needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.ops import gf256, rs_matrix, rs_torch, select
from seaweedfs_tpu_torch.ops.lrc_codec import LrcTorch
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.parallel import distributed_ec, gf2, make_mesh
from seaweedfs_tpu_torch.storage.erasure_coding import ec_encoder
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import DEFAULT_LRC_SCHEME
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme

CPU8 = [torch.device("cpu")] * 8
K, M = 10, 4
W = 512  # words per shard row: splits over 8 positions, and JAX's 8 x stripe
GEOM = dict(data_shards=10, parity_shards=4, large_block_size=4096, small_block_size=1024)
SCHEME, JAX_SCHEME = EcScheme(**GEOM), JaxScheme(**GEOM)
LOST = (0, 3, 10, 13)


def _words(w: int = W, rows: int = K, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=(rows, w), dtype=np.uint32)


def _jax(words: np.ndarray, mesh, spec=P(None, "stripe")):
    return jax.device_put(words, NamedSharding(mesh, spec))


def _shards(words: np.ndarray) -> np.ndarray:
    """The k data rows and their m parity rows, as (k + m, W) words."""
    parity = rs_torch.apply_matrix_reference(
        rs_matrix.matrix_for(K, M)[K:], torch.from_numpy(words).view(torch.uint8))
    return np.concatenate([words, parity.view(torch.uint32).numpy()])


# -- mesh ---------------------------------------------------------------------


def test_make_mesh_shapes():
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.shape == {"shard": 4, "stripe": 2}
    assert make_mesh(1, devices=CPU8).shape == {"shard": 1, "stripe": 1}
    assert make_mesh(8, shard_par=2, devices=CPU8).shape == {"shard": 2, "stripe": 4}
    with pytest.raises(ValueError, match="shard_par"):
        make_mesh(8, shard_par=3, devices=CPU8)
    with pytest.raises(ValueError, match="need 9 devices"):
        make_mesh(9, devices=CPU8)
    assert [(p.shard, p.stripe) for p in mesh.positions] == [(i, j) for i in range(4) for j in range(2)]
    assert mesh.devices == tuple(CPU8) and all(p.stream is None for p in mesh.positions)


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("shard_par", [None, 1, 2, 4])
def test_make_mesh_follows_the_jax_rules(n, shard_par):
    try:
        want = dict(jax_make_mesh(n, shard_par=shard_par).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="shard_par"):
            make_mesh(n, shard_par=shard_par, devices=CPU8)
        assert "shard_par" in str(e)
        return
    assert make_mesh(n, shard_par=shard_par, devices=CPU8).shape == want


# -- partition rules ----------------------------------------------------------


@pytest.mark.parametrize("rules", ["WIDTH_PARTITION_RULES", "ROW_PARTITION_RULES"])
def test_match_partition_rules_gives_the_jax_axis_names(rules):
    named = {"matrix_bits": np.zeros((32, 80), np.uint32), "stripe_words": _words(),
             "scalar_words": np.uint32(3), "one_bits": np.zeros((1, 1), np.uint32)}
    got = distributed_ec.match_partition_rules(getattr(distributed_ec, rules), named)
    want = jax_dec.match_partition_rules(getattr(jax_dec, rules), named)
    assert got == {name: tuple(spec) for name, spec in want.items()}
    assert got["matrix_bits"] == tuple(dict(getattr(jax_dec, rules))[r"_bits$"])
    with pytest.raises(ValueError, match="partition rule not found for array: stray"):
        distributed_ec.match_partition_rules(getattr(distributed_ec, rules),
                                             {"stray": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="partition rule not found for array: stray"):
        jax_dec.match_partition_rules(getattr(jax_dec, rules), {"stray": np.zeros((2, 2))})


# -- gf2 ----------------------------------------------------------------------


def gf2_cases() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(3)
    present = tuple(i not in LOST for i in range(K + M))
    cases = {f"random_{r}x{s}": rng.integers(0, 2, (8 * r, 8 * s), dtype=np.uint32)
             for r, s in [(1, 1), (2, 3), (4, 10), (3, 7)]}
    cases["rs10_4_encode"] = jax_gf2.expand_bits(rs_matrix.matrix_for(K, M)[K:])
    cases["rs10_4_rebuild_4loss"] = jax_gf2.expand_bits(
        rs_matrix.reconstruction_matrix(K, M, present, LOST)[0])
    return cases


@pytest.mark.parametrize("name", sorted(gf2_cases()))
def test_apply_bits_matches_jax(name):
    bits = gf2_cases()[name]
    words = _words(W, bits.shape[1] // 8, seed=len(name))
    got = gf2.apply_bits(bits, torch.from_numpy(words))
    want = np.asarray(jax_gf2.apply_bits(jax.numpy.asarray(bits), jax.numpy.asarray(words)))
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_expand_bits_matches_jax(k, m):
    mat = rs_matrix.matrix_for(k, m)[k:]
    got, want = gf2.expand_bits(mat), jax_gf2.expand_bits(mat)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["random_1x1", "random_2x3", "rs10_4_encode",
                                  "rs10_4_rebuild_4loss"])
def test_plane_route_of_apply_bits_is_the_plain_apply(name):
    """What gf2.apply_bits runs on the card, K3 -> K2 (masks packed from the
    bits) -> K4, held here through the kernels' plain versions: bit c of
    byte j is plane (j, c) in both."""
    bits = gf2_cases()[name]
    x = torch.from_numpy(_words(2 * rs_torch.BLOCK_WORDS, bits.shape[1] // 8, seed=5))
    planes = rs_torch.pack_words_reference(x)
    got = rs_torch.unpack_words_reference(rs_torch.apply_bits_planes_reference(bits, planes))
    assert torch.equal(got, gf2.apply_bits_reference(bits, x))


def test_bits_of_a_gf256_matrix_give_the_gf256_apply():
    mat = rs_matrix.matrix_for(K, M)[K:]
    x = torch.from_numpy(_words())
    want = rs_torch.apply_matrix_reference(mat, x.view(torch.uint8)).view(torch.uint32)
    assert torch.equal(gf2.apply_bits(gf2.expand_bits(mat), x), want)
    assert np.array_equal(gf2.expand_bits(mat), gf256.matrix_to_gf2(mat))


def test_apply_bits_rejects_bad_shapes():
    with pytest.raises(ValueError, match="8r, 8s"):
        gf2.apply_bits(np.zeros((7, 8), np.uint32), torch.zeros((1, 4), dtype=torch.uint32))
    with pytest.raises(ValueError, match=r"\(2, W\) uint32"):
        gf2.apply_bits(np.zeros((8, 16), np.uint32), torch.zeros((3, 4), dtype=torch.uint32))


# -- sharded encode and reconstruct -------------------------------------------


@pytest.mark.parametrize("n,shard_par", [(8, None), (8, 2), (2, None), (1, None)])
def test_sharded_encode_matches_jax(n, shard_par):
    words = _words()
    got = distributed_ec.sharded_encode(
        torch.from_numpy(words), make_mesh(n, shard_par, devices=CPU8), K, M)
    jmesh = jax_make_mesh(n, shard_par=shard_par)
    want = np.asarray(jax_dec.sharded_encode(_jax(words, jmesh), jmesh, K, M))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _shards(words)[K:])


def loss_patterns() -> list[tuple[int, ...]]:
    """A seeded sample of 24 four-loss patterns, plus four data shards."""
    every = list(combinations(range(K + M), 4))
    return sorted(random.Random(11).sample(every, 24)) + [(0, 1, 2, 3)]


def test_sharded_reconstruct_matches_jax_on_sampled_patterns():
    words = _words()
    shards = _shards(words)
    mesh, jmesh = make_mesh(devices=CPU8), jax_make_mesh(8)
    patterns = loss_patterns()
    assert len(patterns) >= 21 and (0, 1, 2, 3) in patterns
    for lost in patterns:
        present = tuple(i not in lost for i in range(K + M))
        inputs = [i for i in range(K + M) if present[i]][:K]
        got = distributed_ec.sharded_reconstruct(
            torch.from_numpy(shards[inputs]), present, lost, mesh, K, M)
        want = jax_dec.sharded_reconstruct(_jax(shards[inputs], jmesh), present, lost, jmesh, K, M)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(lost))
        np.testing.assert_array_equal(got.numpy(), shards[list(lost)], err_msg=str(lost))


def test_rows_mode_pads_output_rows_over_the_shard_axis():
    """3 output rows over 4 shard owners: padded to 4, the pad sliced off."""
    words = _words()
    present = tuple(i not in (1, 5, 12) for i in range(K + M))
    inputs = [i for i in range(K + M) if present[i]][:K]
    shards = _shards(words)
    got = distributed_ec.sharded_reconstruct(
        torch.from_numpy(shards[inputs]), present, (1, 5, 12), make_mesh(devices=CPU8), K, M)
    assert got.shape == (3, W)
    np.testing.assert_array_equal(got.numpy(), shards[[1, 5, 12]])


# -- the mesh codec ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["width", "rows"])
def test_mesh_codec_encode_and_reconstruct_match_jax(mode):
    data = np.random.default_rng(21).integers(0, 256, (K, 3001), dtype=np.uint8)
    codec = distributed_ec.ReedSolomonMesh(K, M, mesh=make_mesh(devices=CPU8), mode=mode)
    jcodec = jax_dec.ReedSolomonMesh(K, M, mesh=jax_make_mesh(8), mode=mode)
    assert codec.mode == mode and codec.device == torch.device("cpu")
    parity = codec.encode(data)
    np.testing.assert_array_equal(parity, jcodec.encode(data))
    np.testing.assert_array_equal(parity, ReedSolomonTorch(K, M, device="cpu").encode(data))
    shards: list = [*data, *parity]
    for lost in [LOST, (0, 1, 2, 3), (13,)]:
        holed = [None if i in lost else s for i, s in enumerate(shards)]
        got, want = codec.reconstruct(holed), jcodec.reconstruct(holed)
        for i in range(K + M):
            np.testing.assert_array_equal(got[i], want[i])
            np.testing.assert_array_equal(got[i], shards[i])


def test_mesh_codec_width_quantum_and_mode_errors(monkeypatch):
    mesh = make_mesh(devices=CPU8)
    width = distributed_ec.ReedSolomonMesh(K, M, mesh=mesh, mode="width")
    rows = distributed_ec.ReedSolomonMesh(K, M, mesh=mesh, mode="rows")
    for n in (1, 31, 32, 33, 1000, 4096):
        assert width._padded_width(n) % (4 * 8) == 0 and 0 <= width._padded_width(n) - n < 32
        assert rows._padded_width(n) % (4 * 2) == 0 and 0 <= rows._padded_width(n) - n < 8
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_MESH_MODE", "rows")
    assert distributed_ec.ReedSolomonMesh(K, M, mesh=mesh).mode == "rows"
    with pytest.raises(ValueError, match="unknown mesh mode"):
        distributed_ec.ReedSolomonMesh(K, M, mesh=mesh, mode="diagonal")


# -- the round-trip step --------------------------------------------------------


@pytest.mark.parametrize("n,shape", [(8, (4, 2)), (1, (1, 1))])
def test_round_trip_step_matches_jax(n, shape):
    words = _words()
    mesh, jmesh = make_mesh(n, devices=CPU8), jax_make_mesh(n)
    assert (mesh.shape["shard"], mesh.shape["stripe"]) == shape == tuple(jmesh.shape.values())
    parity, residual = distributed_ec.ec_round_trip_step(mesh, K, M)(torch.from_numpy(words))
    jparity, jresidual = jax_dec.ec_round_trip_step(jmesh, K, M)(_jax(words, jmesh))
    assert int(residual) == int(jresidual) == 0
    np.testing.assert_array_equal(parity.numpy(), np.asarray(jparity))
    np.testing.assert_array_equal(parity.numpy(), _shards(words)[K:])


def test_round_trip_residual_counts_flipped_bits():
    """The residual is a real check: with a wrong decode matrix it counts
    the differing bits, here against a direct popcount."""
    words = torch.from_numpy(_words())
    flipped = words.clone()
    flipped[0, 5] ^= 0b1011
    assert int(distributed_ec._popcount(flipped.view(torch.uint8) ^ words.view(torch.uint8))) == 3
    got = int(distributed_ec._popcount(words))
    assert got == sum(bin(int(v)).count("1") for v in words.numpy().ravel())


@pytest.mark.parametrize("k,m,n", [(10, 3, 8), (2, 4, 1)])
def test_round_trip_step_refuses_what_jax_refuses(k, m, n):
    with pytest.raises(ValueError) as port_err:
        distributed_ec.ec_round_trip_step(make_mesh(n, devices=CPU8), k, m)
    with pytest.raises(ValueError) as jax_err:
        jax_dec.ec_round_trip_step(jax_make_mesh(n), k, m)
    assert str(port_err.value) == str(jax_err.value)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while a CPU throughput is timed: with several
    test workers on the box, torch's default thread pool oversubscribes
    the cores and a 10 MiB plain apply can take minutes, which the
    record's 3-place rounding (as JAX's) would read as 0.0 GB/s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_measure_scaling_has_the_jax_record_keys(one_torch_thread):
    got = distributed_ec.measure_scaling(device_counts=(1, 8), shard_mb=1, trials=1, devices=CPU8)
    want = jax_dec.measure_scaling(device_counts=(1, 8), shard_mb=1, trials=1)
    assert sorted(got) == sorted(want)
    assert sorted(got["devices"]) == sorted(want["devices"]) == ["1", "8"]
    for n in ("1", "8"):
        assert sorted(got["devices"][n]) == ["encode", "rebuild"]
        assert all(v > 0 for v in got["devices"][n].values())
    assert (got["metric"], got["mode"], got["k"], got["m"], got["backend"]) == (
        "ec_multichip_scaling", "width", K, M, "cpu")


# -- selection and the file pipeline ---------------------------------------------


def test_pipeline_codec_selects_the_mesh_as_the_jax_package_does(monkeypatch):
    for var in ("SEAWEEDFS_TPU_EC_MESH", "SEAWEEDFS_TPU_EC_PIPELINE_ENGINE", "SEAWEEDFS_TPU_EC_ENGINE"):
        monkeypatch.delenv(var, raising=False)
    select._mesh_codec.cache_clear()
    assert type(select.pipeline_codec_for(SCHEME, "cpu")) is ReedSolomonTorch  # one device
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_MESH", "1")
    codec = select.pipeline_codec_for(SCHEME, "cpu")
    assert isinstance(codec, distributed_ec.ReedSolomonMesh)
    assert codec.mesh.devices == (torch.device("cpu"),) and codec.device == torch.device("cpu")
    assert isinstance(select.pipeline_codec_for(DEFAULT_LRC_SCHEME, "cpu"), LrcTorch)
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PIPELINE_ENGINE", "pallas")  # another engine wins
    assert type(select.pipeline_codec(K, M, device="cpu")) is ReedSolomonTorch
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_MESH", "0")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_PIPELINE_ENGINE", "mesh")
    assert isinstance(select.pipeline_codec(K, M, device="cpu"), distributed_ec.ReedSolomonMesh)
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_PIPELINE_ENGINE")
    assert type(select.pipeline_codec(K, M, device="cpu")) is ReedSolomonTorch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            select.pipeline_codec(K, M)


@pytest.fixture(scope="module")
def volume_dir(tmp_path_factory):
    """A volume of ~150 KB: large rows, small rows and a tail."""
    d = tmp_path_factory.mktemp("vol")
    rng = random.Random(42)
    v = Volume(d, vid=1)
    for i in range(300):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 900)))
        v.write_needle(new_needle(i + 1, rng.getrandbits(32), data))
    v.close()
    return d


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _hashes(base: str) -> dict[int, str]:
    return {sid: _sha(base + SCHEME.shard_ext(sid)) for sid in range(K + M)}


@pytest.mark.parametrize("how", ["env", "width", "rows"])
def test_file_pipeline_through_the_mesh_codec_matches_jax(volume_dir, tmp_path, monkeypatch, how):
    """write_ec_files / rebuild_ec_files through the mesh codec give shards
    sha256-identical to the JAX package's mesh codec on the same .dat:
    routed by SEAWEEDFS_TPU_EC_MESH=1 (the one CPU device), and with an
    explicit (4, 2) mesh over [cpu] * 8 in either mode."""
    jb = str(shutil.copytree(volume_dir, tmp_path / "jax") / "1")
    pb = str(shutil.copytree(volume_dir, tmp_path / "port") / "1")
    mode = "width" if how == "env" else how
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_MESH", "1")
    monkeypatch.setenv("SEAWEEDFS_TPU_EC_MESH_MODE", mode)
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_PIPELINE_ENGINE", raising=False)
    monkeypatch.delenv("SEAWEEDFS_TPU_EC_ENGINE", raising=False)
    jcodec = jax_dec.ReedSolomonMesh(K, M, mesh=jax_make_mesh(8), mode=mode)
    jax_ec.write_ec_files(jb, JAX_SCHEME, codec=jcodec, chunk=2048)
    if how == "env":
        select._mesh_codec.cache_clear()
        codec = None
    else:
        codec = distributed_ec.ReedSolomonMesh(K, M, mesh=make_mesh(devices=CPU8), mode=mode)
    stats: dict = {}
    ec_encoder.write_ec_files(pb, SCHEME, codec=codec, chunk=2048, stats=stats, device="cpu")
    assert stats["engine"] == "ReedSolomonMesh"
    want = _hashes(jb)
    assert _hashes(pb) == want
    for sid in LOST:
        os.remove(pb + SCHEME.shard_ext(sid))
    rebuilt = ec_encoder.rebuild_ec_files(pb, SCHEME, codec=codec, chunk=3000, stats=stats,
                                          device="cpu")
    assert rebuilt == sorted(LOST)
    assert _hashes(pb) == want
    assert stats["sched_cache"] == {}  # the CPU plain path caches nothing
