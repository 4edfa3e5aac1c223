"""The port's plane-resident rebuild hop against the JAX package.

Pack (K3), unpack (K4), the plane apply (K2), the stacked apply and
``ReedSolomonCuda.reconstruct_words_multi`` are held byte for byte
(tolerance 0: GF(2) and GF(2^8) arithmetic) against
seaweedfs_tpu.ops.rs_pallas in interpret mode, against
tests/test_rs_planes.np_pack, against ReedSolomonCPU and against the
gfcheck oracle.  Inputs are made with numpy from fixed seeds.  On the CPU
the port's wrappers run their plain versions and launch nothing.  Every
input spans at least two 128 KB blocks: the plane layout is per block, so
one block could not show a cross-block indexing fault.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rs_planes import np_pack

import gfcheck
from seaweedfs_tpu.ops import bitslice, rs_pallas
from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import xor_sched as jax_xor_sched
from seaweedfs_tpu.ops.rs_cpu import ReedSolomonCPU
from seaweedfs_tpu.ops.rs_pallas import ReedSolomonPallas
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, rs_torch, xor_sched
from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda

BW = rs_torch.BLOCK_WORDS
LOST_4 = (0, 3, 10, 13)
SETS_10_4 = [(0,), (3,), (10,), (13,), LOST_4]


def _present(lost, total):
    return tuple(i not in lost for i in range(total))


def _words(rng, rows, blocks=2) -> np.ndarray:
    return rng.integers(0, 2**32, size=(rows, blocks * BW), dtype=np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def plane_matrices() -> dict[str, np.ndarray]:
    """The RS encode rows and a maximal-loss reconstruction matrix, for a
    4-input and a 10-input code."""
    return {
        "rs4_2_encode": rs_matrix.build_encode_matrix(4, 2)[4:],
        "rs4_2_loss2": rs_matrix.reconstruction_matrix(
            4, 2, _present((0, 5), 6), (0, 5))[0],
        "rs10_4_encode": rs_matrix.build_encode_matrix(10, 4)[10:],
        "rs10_4_loss4": rs_matrix.reconstruction_matrix(
            10, 4, _present(LOST_4, 14), LOST_4)[0],
    }


def _counts() -> tuple[int, int, int, int]:
    return (rs_cuda.launches, rs_cuda.pack_launches, rs_cuda.unpack_launches,
            rs_cuda.plane_launches)


@pytest.mark.parametrize("rows,r", [(4, 2), (10, 4)])
def test_pack_apply_unpack_match_pallas_and_np_pack(rows, r):
    """Pack `rows` survivors, apply the RS(rows, r) encode rows, unpack the
    r results: each stage against rs_pallas and np_pack."""
    rng = np.random.default_rng(rows)
    words = _words(rng, rows)
    mat = rs_matrix.build_encode_matrix(rows, r)[rows:]
    before = _counts()
    packed = rs_cuda.pack_words(_t(words)).numpy()
    np.testing.assert_array_equal(packed, np_pack(words))
    np.testing.assert_array_equal(
        packed, np.asarray(rs_pallas.pack_words(jnp.asarray(words), interpret=True)))
    np.testing.assert_array_equal(rs_cuda.unpack_words(_t(packed)).numpy(), words)
    out = rs_cuda.apply_matrix_planes(mat, _t(packed)).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(rs_pallas.apply_matrix_planes(mat, jnp.asarray(packed), interpret=True)))
    unpacked = rs_cuda.unpack_words(_t(out)).numpy()
    np.testing.assert_array_equal(
        unpacked, np.asarray(rs_pallas.unpack_words(jnp.asarray(out), interpret=True)))
    np.testing.assert_array_equal(np_pack(unpacked), out)
    assert _counts() == before  # the plain versions launch nothing


def test_pack_of_all_byte_values_is_a_bijection():
    ramp = (np.arange(2 * BW * 4) + 37 * np.arange(3)[:, None]) % 256
    words = bitslice.bytes_to_words(ramp.astype(np.uint8))
    packed = rs_cuda.pack_words(_t(words)).numpy()
    np.testing.assert_array_equal(packed, np_pack(words))
    np.testing.assert_array_equal(rs_cuda.unpack_words(_t(packed)).numpy(), words)


@pytest.mark.parametrize("name", sorted(plane_matrices()))
def test_apply_matrix_planes_matches_pallas(name):
    mat = plane_matrices()[name]
    rng = np.random.default_rng(len(name))
    planes = np_pack(_words(rng, mat.shape[1]))
    got = rs_cuda.apply_matrix_planes(mat, _t(planes)).numpy()
    want = np.asarray(rs_pallas.apply_matrix_planes(mat, jnp.asarray(planes), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_apply_matrices_planes_matches_pallas():
    lost = (0, 7)
    present = _present(lost, 9)
    mats = [rs_matrix.reconstruction_matrix(6, 3, present, ts)[0]
            for ts in [(0,), (7,), (0, 7)]]
    planes = np_pack(_words(np.random.default_rng(9), 6))
    got = rs_cuda.apply_matrices_planes(mats, _t(planes))
    want = rs_pallas.apply_matrices_planes(mats, jnp.asarray(planes), interpret=True)
    assert [g.shape[0] for g in got] == [1, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,m,lost,target_sets", [
    (6, 3, (0, 7), [(0,), (7,), (0, 7)]),
    (10, 4, LOST_4, SETS_10_4),
])
def test_reconstruct_words_multi_matches_pallas_and_cpu(k, m, lost, target_sets):
    cpu = ReedSolomonCPU(k, m)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(k, 2 * BW * 4), dtype=np.uint8)
    shards = np.concatenate([data, cpu.encode(data)])
    present = _present(lost, k + m)
    port = ReedSolomonCuda(k, m, device="cpu")
    _mat, inputs, _mode = port.recon_plan(present, lost)
    words = bitslice.bytes_to_words(np.ascontiguousarray(shards[list(inputs)]))
    before = _counts()
    got = port.reconstruct_words_multi(present, target_sets, _t(words))
    assert _counts() == before
    want = ReedSolomonPallas(k, m, interpret=True).reconstruct_words_multi(
        present, target_sets, jnp.asarray(words))
    holed = [None if i in lost else shards[i] for i in range(k + m)]
    cpu_out = cpu.reconstruct(list(holed))
    for ts, g, w in zip(target_sets, got, want):
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))
        rebuilt = bitslice.words_to_bytes(g)
        byte_path = port.reconstruct(list(holed), targets=ts)
        for row, t in enumerate(ts):
            np.testing.assert_array_equal(rebuilt[row], shards[t])
            np.testing.assert_array_equal(rebuilt[row], cpu_out[t])
            np.testing.assert_array_equal(rebuilt[row], byte_path[t])


def test_reconstruct_words_multi_takes_numpy_words_and_no_sets():
    port = ReedSolomonCuda(4, 2, device="cpu")
    present = _present((0,), 6)
    assert port.reconstruct_words_multi(present, [], np.zeros((4, BW), np.uint32)) == []
    out = port.reconstruct_words_multi(present, [(0,)], np.zeros((4, 2 * BW), np.uint32))
    assert out[0].dtype == torch.uint32 and out[0].shape == (1, 2 * BW)
    assert not out[0].any()


class _PlanPerTargets:
    """A recon_plan whose inputs depend on the targets, as an LRC plan's
    do, so the hop's same-inputs check can fire."""

    def recon_plan(self, present, targets):
        mat, inputs, mode = super().recon_plan(present, targets)
        return mat, inputs if targets == (0,) else tuple(reversed(inputs)), mode


class _PortPerTargets(_PlanPerTargets, ReedSolomonCuda):
    pass


class _PallasPerTargets(_PlanPerTargets, ReedSolomonPallas):
    pass


def test_reconstruct_words_multi_error_paths_match_pallas():
    present = _present((0,), 6)
    port = ReedSolomonCuda(4, 2, device="cpu")
    jax_codec = ReedSolomonPallas(4, 2, interpret=True)
    for codec in (port, jax_codec):
        with pytest.raises(ValueError, match="rows"):
            codec.reconstruct_words_multi(present, [(0,)], np.zeros((3, BW), np.uint32))
        with pytest.raises(ValueError, match=f"not a multiple of {BW} words"):
            codec.reconstruct_words_multi(present, [(0,)], np.zeros((4, 1000), np.uint32))
    for codec in (_PortPerTargets(4, 2, device="cpu"), _PallasPerTargets(4, 2, interpret=True)):
        with pytest.raises(ValueError, match="same inputs"):
            codec.reconstruct_words_multi(present, [(0,), (1,)], np.zeros((4, BW), np.uint32))


def test_plane_functions_reject_partial_blocks_as_pallas_does():
    mat = plane_matrices()["rs4_2_encode"]
    bad = np.zeros((4, BW + 4), np.uint32)
    for port_fn, jax_fn in [
        (rs_cuda.pack_words, lambda x: rs_pallas.pack_words(x, interpret=True)),
        (rs_cuda.unpack_words, lambda x: rs_pallas.unpack_words(x, interpret=True)),
        (lambda x: rs_cuda.apply_matrix_planes(mat, x),
         lambda x: rs_pallas.apply_matrix_planes(mat, x, interpret=True)),
    ]:
        with pytest.raises(ValueError, match=f"not a multiple of {BW} words"):
            port_fn(_t(bad))
        with pytest.raises(ValueError, match=f"not a multiple of {BW} words"):
            jax_fn(jnp.asarray(bad))
    with pytest.raises(ValueError, match="takes 4 rows"):
        rs_cuda.apply_matrix_planes(mat, torch.zeros((3, BW), dtype=torch.uint32))
    for w in (0, 1, BW, BW + 1, 5 * BW - 1):
        assert rs_cuda.pad_width_words(w) == rs_pallas.pad_width_words(w)


def test_plane_wrappers_never_run_a_non_cpu_tensor_on_the_host():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises."""
    x = torch.empty((4, BW), dtype=torch.uint32, device="meta")
    mat = plane_matrices()["rs4_2_encode"]
    for fn in (rs_cuda.pack_words, rs_cuda.unpack_words,
               lambda t: rs_cuda.apply_matrix_planes(mat, t)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x)


def test_plane_session_oracle_check_over_the_port():
    """gfcheck.verify_plane_session's check over the port's hop: the
    combined all-lanes input through pack, the stacked apply and unpack,
    each result against the GF(2^8) table oracle."""
    present = _present(LOST_4, 14)
    mats = [rs_matrix.reconstruction_matrix(10, 4, present, ts)[0] for ts in SETS_10_4]
    mats.append(rs_matrix.build_encode_matrix(10, 4)[10:])
    data = gfcheck.combined_input(10, 2 * BW * 4)
    planes = rs_cuda.pack_words(_t(bitslice.bytes_to_words(data)))
    outs = rs_cuda.apply_matrices_planes(mats, planes)
    for mat, out in zip(mats, outs):
        got = bitslice.words_to_bytes(rs_cuda.unpack_words(out).numpy())
        np.testing.assert_array_equal(got, jax_gf256.mat_mul(mat, data))


def test_gf2_lowering_matches_the_jax_package():
    for c in range(256):
        np.testing.assert_array_equal(
            gf256.coeff_to_gf2_block(c), jax_gf256.coeff_to_gf2_block(c))
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(gf256.matrix_to_gf2(every), jax_gf256.matrix_to_gf2(every))
    assert gf256.matrix_to_gf2(rs_matrix.build_encode_matrix(10, 4)[10:]).sum() == 1224


@pytest.mark.parametrize("lost", [(3,), (0, 9), LOST_4, (10, 11, 12, 13)])
def test_stacking_matches_the_jax_package(lost):
    present = _present(lost, 14)
    mats = [rs_matrix.reconstruction_matrix(10, 4, present, (t,))[0] for t in lost]
    mats.append(rs_matrix.reconstruction_matrix(10, 4, present, lost)[0])
    stacked, rows = xor_sched.stack_matrices(mats)
    jax_stacked, jax_rows = jax_xor_sched.stack_matrices(mats)
    np.testing.assert_array_equal(stacked, jax_stacked)
    assert rows == jax_rows == [1] * len(lost) + [len(lost)]
    # the port lowers the stack with gf256.matrix_to_gf2: the JAX joint_bits
    jax_bits, jax_bit_rows = jax_xor_sched.joint_bits(mats)
    np.testing.assert_array_equal(gf256.matrix_to_gf2(stacked), jax_bits)
    assert [8 * r for r in rows] == jax_bit_rows
    np.testing.assert_array_equal(gf256.matrix_to_gf2(mats[-1]), jax_xor_sched.ring_bits(mats[-1]))
    with pytest.raises(ValueError):
        xor_sched.stack_matrices([])
    with pytest.raises(ValueError):
        xor_sched.stack_matrices([mats[0], mats[0][:, :9]])
