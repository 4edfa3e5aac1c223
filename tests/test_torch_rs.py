"""The port's GF(2^8) apply and RS codec against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages;
every comparison is byte-exact (tolerance 0: the arithmetic is over
GF(2^8)).  On the CPU the port runs its plain versions: the CUDA wrapper
routes CPU tensors to ``apply_matrix_reference`` and launches nothing.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfcheck
from seaweedfs_tpu.ops import bitslice, rs_jax
from seaweedfs_tpu.ops.rs_cpu import ReedSolomonCPU
from seaweedfs_tpu.ops.rs_jax import ReedSolomonJax
from seaweedfs_tpu.ops.rs_pallas import BLOCK_WORDS, apply_matrix_pallas
from seaweedfs_tpu_torch.ops import rs_cuda, rs_matrix
from seaweedfs_tpu_torch.ops.rs_cuda import ReedSolomonCuda, apply_matrix_cuda
from seaweedfs_tpu_torch.ops.rs_torch import (
    ReedSolomonTorch,
    apply_matrix_reference,
    resolve_device,
)

LOST_1 = (3,)
LOST_4 = (0, 3, 10, 13)


def _present(lost, total=14):
    return tuple(i not in lost for i in range(total))


def rs10_4_matrices() -> dict[str, np.ndarray]:
    """K1's main-path matrices: the RS(10,4) encode rows and a 1-loss and
    a 4-loss reconstruction matrix."""
    return {
        "encode": rs_matrix.build_encode_matrix(10, 4)[10:],
        "loss1": rs_matrix.reconstruction_matrix(10, 4, _present(LOST_1), LOST_1)[0],
        "loss4": rs_matrix.reconstruction_matrix(10, 4, _present(LOST_4), LOST_4)[0],
    }


def more_matrices() -> dict[str, np.ndarray]:
    return {
        **rs10_4_matrices(),
        "rs6_3": rs_matrix.build_encode_matrix(6, 3)[6:],
        "rs12_4": rs_matrix.build_encode_matrix(12, 4)[12:],
        "cauchy10_4": rs_matrix.build_cauchy_matrix(10, 4)[10:],
    }


def _port_apply_words(matrix, words: np.ndarray) -> np.ndarray:
    data = torch.from_numpy(words.copy()).view(torch.uint8)
    return apply_matrix_reference(matrix, data).view(torch.uint32).numpy()


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("name", ["encode", "loss1", "loss4"])
def test_reference_matches_pallas_kernel_interpret(name, blocks):
    """K1 itself (Pallas, interpret mode) at its block granularity."""
    mat = rs10_4_matrices()[name]
    rng = np.random.default_rng(100 + blocks)
    words = rng.integers(0, 2**32, size=(10, blocks * BLOCK_WORDS), dtype=np.uint32)
    want = np.asarray(apply_matrix_pallas(mat, jnp.asarray(words), interpret=True))
    np.testing.assert_array_equal(_port_apply_words(mat, words), want)


@pytest.mark.parametrize("width", [1, 3, 4097])
@pytest.mark.parametrize("name", sorted(more_matrices()))
def test_reference_matches_rs_jax_apply_at_ragged_widths(name, width):
    mat = more_matrices()[name]
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, size=(mat.shape[1], width), dtype=np.uint8)
    padded = np.zeros((mat.shape[1], bitslice.padded_width(width)), dtype=np.uint8)
    padded[:, :width] = data
    want = bitslice.words_to_bytes(
        np.asarray(rs_jax.apply_matrix(mat, bitslice.bytes_to_words(padded)))
    )[:, :width]
    got = apply_matrix_reference(mat, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cuda_wrapper_on_cpu_tensors_runs_the_plain_version():
    mat = rs10_4_matrices()["loss4"]
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, size=(10, 4096), dtype=np.uint8))
    before = rs_cuda.launches
    got = apply_matrix_cuda(mat, data)
    words = apply_matrix_cuda(mat, data.view(torch.uint32))
    assert rs_cuda.launches == before  # nothing launched on the CPU
    assert words.dtype == torch.uint32 and words.shape == (4, 1024)
    want = apply_matrix_reference(mat, data)
    assert torch.equal(got, want)
    assert torch.equal(words.view(torch.uint8), want)


def test_cuda_wrapper_rejects_bad_inputs():
    mat = rs10_4_matrices()["encode"]
    with pytest.raises(ValueError):
        apply_matrix_cuda(mat, torch.zeros((10, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        apply_matrix_cuda(mat, torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        apply_matrix_cuda(mat, torch.zeros((10, 8, 2), dtype=torch.uint8))
    with pytest.raises(ValueError):
        apply_matrix_cuda(mat[0], torch.zeros((10, 8), dtype=torch.uint8))


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_codec_encode_matches_jax_and_cpu(k, m):
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, size=(k, 1000), dtype=np.uint8)
    got = ReedSolomonTorch(k, m, device="cpu").encode(data)
    np.testing.assert_array_equal(got, ReedSolomonJax(k, m).encode(data))
    np.testing.assert_array_equal(got, ReedSolomonCPU(k, m).encode(data))
    words = torch.from_numpy(bitslice.bytes_to_words(data[:, :992]).copy())
    np.testing.assert_array_equal(
        ReedSolomonTorch(k, m, device="cpu").encode_words(words).numpy(),
        np.asarray(ReedSolomonJax(k, m).encode_words(jnp.asarray(words.numpy()))),
    )


def test_cuda_codec_on_cpu_matches_torch_codec():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(10, 777), dtype=np.uint8)
    np.testing.assert_array_equal(
        ReedSolomonCuda(10, 4, device="cpu").encode(data),
        ReedSolomonTorch(10, 4, device="cpu").encode(data),
    )


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_codec_reconstruct_matches_jax_and_cpu(k, m):
    rng = np.random.default_rng(k * 7 + m)
    data = rng.integers(0, 256, size=(k, 999), dtype=np.uint8)
    full = np.concatenate([data, ReedSolomonCPU(k, m).encode(data)])
    lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
    holed = [None if i in lost else full[i] for i in range(k + m)]
    port = ReedSolomonTorch(k, m, device="cpu")
    got = port.reconstruct(list(holed))
    jax_out = ReedSolomonJax(k, m).reconstruct(list(holed))
    cpu_out = ReedSolomonCPU(k, m).reconstruct(list(holed))
    for i in range(k + m):
        np.testing.assert_array_equal(got[i], full[i])
        np.testing.assert_array_equal(got[i], jax_out[i])
        np.testing.assert_array_equal(got[i], cpu_out[i])
    # data_only fills only data slots; targets= restricts to the named ones
    data_only = port.reconstruct(list(holed), data_only=True)
    for i in range(k + m):
        if i in lost and i >= k:
            assert data_only[i] is None
        else:
            np.testing.assert_array_equal(data_only[i], full[i])
    target = (lost[-1],)
    one = port.reconstruct(list(holed), targets=target)
    jax_one = ReedSolomonJax(k, m).reconstruct(list(holed), targets=target)
    np.testing.assert_array_equal(one[target[0]], jax_one[target[0]])
    assert all(one[i] is None for i in lost if i not in target)


def test_reconstruct_device_matches_plan():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(10, 256), dtype=np.uint8)
    full = np.concatenate([data, ReedSolomonCPU(10, 4).encode(data)])
    codec = ReedSolomonTorch(10, 4, device="cpu")
    _mat, inputs, mode = codec.recon_plan(_present(LOST_4), LOST_4)
    assert mode == "global"
    out = codec.reconstruct_device(_present(LOST_4), LOST_4, torch.from_numpy(full[list(inputs)]))
    np.testing.assert_array_equal(out.view(torch.uint8).numpy(), full[list(LOST_4)])
    with pytest.raises(ValueError):
        codec.reconstruct_device(_present(LOST_4), LOST_4, torch.from_numpy(full[:9]))


def test_reconstruct_too_few_shards_raises():
    codec = ReedSolomonTorch(10, 4, device="cpu")
    shards = [np.zeros(64, np.uint8)] * 9 + [None] * 5
    with pytest.raises(ValueError, match="too few"):
        codec.reconstruct(shards)
    with pytest.raises(ValueError, match="k\\+m"):
        codec.reconstruct(shards[:13])
    with pytest.raises(ValueError):
        codec.encode(np.zeros((9, 64), np.uint8))


@pytest.mark.parametrize("k,m", [(0, 4), (4, 0), (-1, 2), (200, 100)])
def test_bad_geometry_raises(k, m):
    with pytest.raises(ValueError):
        ReedSolomonTorch(k, m, device="cpu")
    with pytest.raises(ValueError):
        ReedSolomonJax(k, m)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReedSolomonTorch(10, 4)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("apply", [apply_matrix_reference, apply_matrix_cuda],
                         ids=["reference", "cuda_wrapper"])
@pytest.mark.parametrize("name", ["encode", "loss4"])
def test_gfcheck_basis_vector_proof(apply, name):
    mat = rs10_4_matrices()[name]

    def apply_bytes(data: np.ndarray) -> np.ndarray:
        return apply(mat, torch.from_numpy(np.ascontiguousarray(data))).numpy()

    assert gfcheck.verify_kernel(apply_bytes, mat, 256 * gfcheck.GROUP, f"torch-{name}") == []


def test_gfcheck_catches_a_wrong_kernel():
    """The proof above can fail: a corrupted apply is reported."""
    mat = rs10_4_matrices()["encode"]

    def broken(data: np.ndarray) -> np.ndarray:
        out = apply_matrix_reference(mat, torch.from_numpy(data)).numpy()
        out[1, 5] ^= 1
        return out

    assert gfcheck.verify_kernel(broken, mat, 256 * gfcheck.GROUP, "broken")
