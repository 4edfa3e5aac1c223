"""The port's host GF(2^8) codec (csrc/gf256.cpp bound in
ops/gf256_native.py, ops/rs_cpu.ReedSolomonCPU, ops/lrc_codec.LrcCPU)
against the JAX package's ReedSolomonCPU / LrcCPU and the field's product
table: random shapes, the coefficients 0 and 1 and tail lengths around the
16-byte SIMD step, non-contiguous inputs, the row form's contract,
gfcheck's per-lane proof, the leaf+XOR executor on the JAX planner's
programs, ``reconstruct`` byte-equal to the JAX codec on every 1- and
2-loss pattern of LRC(10,2,2) and 32 seeded RS(10,4) patterns, and the
codec selection of degraded reads and scrub repairs."""

from __future__ import annotations

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import sched_cache as jax_sched_cache
from seaweedfs_tpu.ops.lrc_codec import LrcCPU as JaxLrcCPU
from seaweedfs_tpu.ops.rs_cpu import ReedSolomonCPU as JaxReedSolomonCPU
from seaweedfs_tpu_torch.ops import _build, gf256, gf256_native, lrc_matrix, rs_matrix, select
from seaweedfs_tpu_torch.ops.lrc_codec import LrcCPU, LrcTorch
from seaweedfs_tpu_torch.ops.rs_cpu import ReedSolomonCPU
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch
from seaweedfs_tpu_torch.storage.erasure_coding.lrc import DEFAULT_LRC_SCHEME
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import gfcheck  # noqa: E402 — the repo's tools/ checker


@pytest.mark.parametrize("seed", range(4))
def test_mat_mul_equals_the_product_table_on_random_shapes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        rows, k, n = (int(rng.integers(1, 15)), int(rng.integers(1, 15)),
                      int(rng.integers(1, 300)))
        a = rng.integers(0, 256, (rows, k), dtype=np.uint8)
        b = rng.integers(0, 256, (k, n), dtype=np.uint8)
        want = np.bitwise_xor.reduce(jax_gf256.MUL_TABLE[a[:, :, None], b[None, :, :]], axis=1)
        assert np.array_equal(gf256_native.gf_mat_mul(a, b), want)
        assert np.array_equal(gf256_native.gf_mat_mul(a, b), gf256.mat_mul(a, b))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 1000, 4096 + 5, 65536 + 3])
def test_edge_coefficients_and_tail_lengths(n):
    """Coefficients 0 and 1 take their own paths, lengths around the
    16-byte step exercise the scalar tail, and a length past 64 KiB crosses
    the row form's column block."""
    rng = np.random.default_rng(n)
    b = rng.integers(0, 256, (3, n), dtype=np.uint8)
    a = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 255]], dtype=np.uint8)
    want = jax_gf256.mat_mul(a, b)
    assert np.array_equal(gf256_native.gf_mat_mul(a, b), want)
    out = [np.full(n, 0xAA, dtype=np.uint8) for _ in range(3)]  # overwritten, not xored
    gf256_native.gf_mat_mul_rows(a, list(b), out)
    assert np.array_equal(np.stack(out), want)


def test_non_contiguous_inputs():
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, (10, 64), dtype=np.uint8)
    view = big[::2, ::2]  # a strided view: the matrix form copies it
    a = rng.integers(0, 256, (2, 5), dtype=np.uint8)
    assert np.array_equal(gf256_native.gf_mat_mul(a, view), jax_gf256.mat_mul(a, view))
    assert np.array_equal(gf256_native.gf_mat_mul(a.T.copy().T, view), jax_gf256.mat_mul(a, view))
    # the row form takes rows that are each contiguous, at any address
    # (slices of one buffer, as the pipeline's reused parity buffer gives)
    src = [big[i, 3:59] for i in range(5)]
    out_buf = np.zeros((2, 80), dtype=np.uint8)
    gf256_native.gf_mat_mul_rows(a, src, [out_buf[0, 7:63], out_buf[1, 11:67]])
    want = jax_gf256.mat_mul(a, np.stack(src))
    assert np.array_equal(out_buf[0, 7:63], want[0]) and np.array_equal(out_buf[1, 11:67], want[1])
    assert not out_buf[0, :7].any() and not out_buf[1, 67:].any()


def test_row_form_refuses_rows_it_would_overrun():
    a = np.ones((2, 3), dtype=np.uint8)
    rows = [np.zeros(32, dtype=np.uint8) for _ in range(3)]
    out = [np.zeros(32, dtype=np.uint8) for _ in range(2)]
    for bad_src, bad_out, match in (
            (rows[:2], out, "need 3 src rows"),
            (rows[:2] + [np.zeros(16, dtype=np.uint8)], out, "32 bytes"),
            (rows, [out[0], np.zeros(64, dtype=np.uint8)[::2]], "C-contiguous"),
            (rows, [out[0], np.zeros(32, dtype=np.int16)], "uint8")):
        with pytest.raises(ValueError, match=match):
            gf256_native.gf_mat_mul_rows(a, bad_src, bad_out)


@pytest.mark.parametrize("code", ["rs", "lrc"])
def test_codec_equals_jax_reed_solomon_cpu(code):
    """Encode, encode_rows and reconstruct (every data loss set of up to
    four, RS; local and global plans, LRC) are byte-equal to the JAX host
    codec and to the plain torch codec on the CPU."""
    rng = np.random.default_rng(21)
    if code == "rs":
        port, jax, plain = ReedSolomonCPU(10, 4), JaxReedSolomonCPU(10, 4), ReedSolomonTorch(
            10, 4, device="cpu")
        losses = [(0,), (3, 11), (0, 5, 12, 13), (1, 2, 3, 4)]
    else:
        port, jax, plain = LrcCPU(10, 2, 2), JaxLrcCPU(10, 2, 2), LrcTorch(10, 2, 2, "cpu")
        losses = [(3,), (3, 7), (10,), (0, 5, 12, 13)]
    data = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    parity = port.encode(data)
    assert np.array_equal(parity, jax.encode(data))
    assert np.array_equal(parity, plain.encode(data))
    rows = [np.zeros(4099, dtype=np.uint8) for _ in range(4)]
    port.encode_rows(list(data), rows)
    assert np.array_equal(np.stack(rows), parity)
    shards = list(data) + list(parity)
    for lost in losses:
        holey = [None if i in lost else s for i, s in enumerate(shards)]
        assert port.recon_plan(tuple(s is not None for s in holey), lost)[1:] == \
            jax.recon_plan(tuple(s is not None for s in holey), lost)[1:]
        got = port.reconstruct(list(holey), targets=lost)
        want = jax.reconstruct(list(holey), targets=lost)
        assert all(np.array_equal(got[t], want[t]) and np.array_equal(got[t], shards[t])
                   for t in lost), lost
        full = port.reconstruct(list(holey))
        assert all(np.array_equal(full[i], shards[i]) for i in range(14))


def test_gfcheck_verify_kernel_passes():
    """tools/gfcheck's per-lane basis inputs and its all-lanes input, at a
    width past one column block, over the encode, a 4-loss decode and the
    LRC matrices."""
    present = tuple(i not in (0, 5, 12, 13) for i in range(14))
    decode, _inputs = rs_matrix.reconstruction_matrix(10, 4, present, (0, 5, 12, 13))
    local, _inputs, mode = lrc_matrix.reconstruction_plan(
        10, 2, 2, tuple(i != 3 for i in range(14)), (3,))
    assert mode == "local"
    for tag, mat in (("encode", rs_matrix.matrix_for(10, 4)[10:]), ("decode", decode),
                     ("lrc", lrc_matrix.build_lrc_matrix(10, 2, 2)[10:]), ("local", local)):
        def rows_apply(data, mat=mat):
            out = [np.empty(data.shape[1], dtype=np.uint8) for _ in range(mat.shape[0])]
            gf256_native.gf_mat_mul_rows(mat, list(data), out)
            return np.stack(out)

        for fn in (lambda data, mat=mat: gf256_native.gf_mat_mul(mat, data), rows_apply):
            assert gfcheck.verify_kernel(fn, mat, 9 * 8192, tag) == []
    broken = lambda data: gf256_native.gf_mat_mul(decode, data) ^ 1  # noqa: E731
    assert gfcheck.verify_kernel(broken, decode, 8192, "broken")


def test_sched_apply_runs_the_jax_planners_programs():
    """The leaf+XOR executor of the port's copy, fed the JAX planner's
    programs (LRC local repairs plan to pure XOR), equals the dense apply;
    a program that reads a term before it exists is refused."""
    rng = np.random.default_rng(5)
    mats = [lrc_matrix.reconstruction_plan(10, 2, 2, tuple(i not in lost for i in range(14)),
                                           lost)[0]
            for lost in ((3,), (3, 7), (0, 5, 12, 13))]
    mats += [np.array([[1, 1, 1, 0], [1, 1, 0, 1], [0, 1, 1, 1]], dtype=np.uint8)]
    planned = 0
    for mat in mats:
        sched = jax_sched_cache.host_schedule(mat)
        if sched is None:
            continue
        planned += 1
        src = [rng.integers(0, 256, 5003, dtype=np.uint8) for _ in range(mat.shape[1])]
        out = [np.empty(5003, dtype=np.uint8) for _ in range(mat.shape[0])]
        gf256_native.gf_sched_apply(sched, src, out)
        assert np.array_equal(np.stack(out), jax_gf256.mat_mul(mat, np.stack(src)))
    assert planned >= 2
    import dataclasses

    bad = dataclasses.replace(sched, shared_ops=np.array([len(sched.leaf_coeff) + 5, 0],
                                                         dtype=np.uint32))
    with pytest.raises(ValueError, match="before it exists"):
        gf256_native.gf_sched_apply(bad, src, out)


def _loss_patterns(code: str) -> list[tuple[int, ...]]:
    """Every 1 and 2 losses of LRC(10,2,2) (its local repairs and its
    global decodes), 32 seeded patterns of 1-4 losses of RS(10,4)."""
    if code == "lrc":
        return [lost for n in (1, 2) for lost in itertools.combinations(range(14), n)]
    rng = np.random.default_rng(2108)
    out = []
    while len(out) < 32:
        n = int(rng.integers(1, 5))
        out.append(tuple(sorted(int(x) for x in rng.choice(14, n, replace=False))))
    return out


@pytest.mark.parametrize("code", ["rs", "lrc"])
def test_reconstruct_equals_jax_on_the_matrix_set(code):
    """Each loss pattern's reconstruct is byte-equal to the JAX codec's and
    to the lost shards."""
    rng = np.random.default_rng(3)
    if code == "rs":
        port, jax = ReedSolomonCPU(10, 4), JaxReedSolomonCPU(10, 4)
    else:
        port, jax = LrcCPU(10, 2, 2), JaxLrcCPU(10, 2, 2)
    data = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    shards = list(data) + list(port.encode(data))
    for lost in _loss_patterns(code):
        holey = [None if i in lost else s for i, s in enumerate(shards)]
        got = port.reconstruct(list(holey), targets=lost)
        want = jax.reconstruct(list(holey), targets=lost)
        assert all(np.array_equal(got[t], want[t]) and np.array_equal(got[t], shards[t])
                   for t in lost), lost


def test_small_read_codec_is_the_native_host_codec():
    rs = select.small_read_codec_for(EcScheme())
    lrc = select.small_read_codec_for(DEFAULT_LRC_SCHEME)
    assert type(rs) is ReedSolomonCPU and type(lrc) is LrcCPU
    assert select.small_read_codec(10, 4) is rs  # cached: one codec per geometry
    assert (lrc.data_shards, lrc.local_groups, lrc.global_parities) == (10, 2, 2)
    assert select.small_read_codec_for(EcScheme(6, 3)).matrix.shape == (9, 6)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: when g++ cannot build csrc/gf256.cpp the load raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "GXX_FLAGS", ("-std=c++17", "-O3", "-shared", "-fPIC",
                                              "-DSW_BROKEN", "--no-such-flag"))
    monkeypatch.setattr(_build, "_loaded", {})
    gf256_native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed for csrc/gf256.cpp"):
            gf256_native.gf_mat_mul(np.ones((1, 1), np.uint8), np.ones((1, 4), np.uint8))
    finally:
        gf256_native._lib.cache_clear()
