"""The table-driven GF(2) apply of csrc/gf_table.cuh, emulated on the CPU.

K1 (csrc/gf_apply.cu) and K2 (csrc/gf_planes.cu) replace per-bit tests by
the method of four Russians: for each input row j and half h the 16 XORs
of subsets of planes 4h..4h+3 are built, and each output plane XORs in the
entry whose index is the four matrix bits of (plane, j, h).  CUDA cannot
run here, so this file runs the kernels' loops in torch, step for step:
K2 with the mask nibbles that ``rs_cuda.pack_masks`` hands the kernel,
and K1 with its tile mapping (two 16-byte pieces per 32-byte column), its
in-register bit transpose, the table offsets it derives from the GF(2^8)
matrix inside each block, its zero-filled tail and its grid.y groups of 8
output rows.  Each emulation is held byte for byte (tolerance 0: GF(2)
arithmetic) against the port's plain versions and against the JAX package
(rs_pallas in interpret mode, rs_jax).  That pins the bit order of the
table indices, which a transposed nibble would break only for matrices
that are not symmetric: hence the Cauchy, 4-loss and stacked matrices.
The last tests pin the bounds chip_smoke.py computes from the table
apply's XOR count.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_planes import plane_matrices

from seaweedfs_tpu.ops import bitslice, rs_jax, rs_pallas
from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_matrix, rs_torch, xor_sched

BW = rs_torch.BLOCK_WORDS
PW = rs_torch.PLANE_WORDS
# K1's column tiling follows the kernels' block size.
THREADS = int(re.search(
    r"constexpr int kThreads = (\d+);",
    (Path(rs_cuda.__file__).parent.parent / "csrc" / "gf_table.cuh").read_text()).group(1))
HALF_TILE = 16 * THREADS
TILE = 2 * HALF_TILE
MASK32 = 0xFFFFFFFF
MIB = 1 << 20
H100_RATES = {"logic_ops_per_s": 132 * 64 * 1980e6}  # 132 SMs at clocks.max.sm 1980 MHz


def _present(lost, total=14):
    return tuple(i not in lost for i in range(total))


def _loss4(lost):
    return rs_matrix.reconstruction_matrix(10, 4, _present(lost), lost)[0]


def stacks() -> dict[str, np.ndarray]:
    """The 5-set stack of the plane hop (8 rows) and three 4-loss sets
    (12 rows: two groups of 8)."""
    lost = (0, 3, 10, 13)
    sets = [(0,), (3,), (10,), (13,), lost]
    mats = [rs_matrix.reconstruction_matrix(10, 4, _present(lost), ts)[0] for ts in sets]
    return {
        "rs10_4_5set_stack": xor_sched.stack_matrices(mats)[0],
        "rs10_4_3x4loss_stack": xor_sched.stack_matrices(
            [_loss4(lost) for lost in [(0, 3, 10, 13), (1, 2, 11, 12), (4, 5, 6, 7)]])[0],
    }


def all_matrices() -> dict[str, np.ndarray]:
    return {**plane_matrices(), **stacks(),
            "cauchy10_4_encode": rs_matrix.build_cauchy_matrix(10, 4)[10:]}


def group_rows(r: int) -> int:
    """R, the output rows of one grid.y group, as both launchers pick it."""
    return 1 if r == 1 else 2 if r == 2 else 4 if r <= 4 else 8


# -- the table apply ----------------------------------------------------------


def build_table(p: list[torch.Tensor]) -> list[torch.Tensor]:
    """gf::build_table: entry k = XOR of p[c] over the set bits c of k."""
    t = [torch.zeros_like(p[0])]
    for k in range(1, 16):
        low = k & -k
        t.append(t[k ^ low] ^ p[low.bit_length() - 1])
    return t


def table_apply(planes: list[list[torch.Tensor]], index, r: int, s: int, R: int):
    """The kernels' loop: for each grid.y group of R output rows and each
    step u = 2j + h, build the table of row j's half h, then XOR entry
    index(i, j, h) into each output plane i of the group."""
    out = [[torch.zeros_like(planes[0][0]) for _b in range(8)] for _o in range(r)]
    for o0 in range(0, r, R):
        for u in range(2 * s):
            j, h = u >> 1, u & 1
            table = build_table(planes[j][4 * h : 4 * h + 4])
            for i in range(8 * min(R, r - o0)):
                o, p = o0 + i // 8, i % 8
                out[o][p] = out[o][p] ^ table[index(o, p, j, h)]
    return out


def emulate_k2(matrix: np.ndarray, words: np.ndarray, R: int | None = None) -> np.ndarray:
    """K2 on (s, W) plane-interleaved uint32 rows, indexed by the nibbles
    of the mask bytes sw_gf_planes_apply receives."""
    r, s = matrix.shape
    masks = rs_cuda.pack_masks(gf256.matrix_to_gf2(matrix))
    x = torch.from_numpy(words.astype(np.int64)).reshape(s, -1, 8, PW)
    planes = [[x[j, :, b] for b in range(8)] for j in range(s)]
    out = table_apply(planes, lambda o, p, j, h: (int(masks[8 * o + p, j]) >> (4 * h)) & 15,
                      r, s, R or group_rows(r))
    return torch.stack([torch.stack(o, dim=1) for o in out]).reshape(r, -1).numpy().astype(np.uint32)


# -- K1: tiles, transpose, offsets from the GF(2^8) matrix ---------------------


def xtime(a: int) -> int:
    a <<= 1
    return a ^ 0x11D if a & 0x100 else a


def k1_index(matrix: np.ndarray, o: int, p: int, j: int, h: int) -> int:
    """gf_apply_kernel's table entry: bit c = bit p of M[o][j] * x^(4h + c)."""
    a = int(matrix[o, j])
    for _ in range(4 * h):
        a = xtime(a)
    k = 0
    for c in range(4):
        k |= ((a >> p) & 1) << c
        a = xtime(a)
    return k


def delta_swap(x: list, i: int, j: int, shift: int, mask: int) -> None:
    t = ((x[i] >> shift) ^ x[j]) & mask
    x[j] = x[j] ^ t
    x[i] = (x[i] ^ (t << shift)) & MASK32


def transpose8(x: list) -> list:
    """gf::transpose8 on 8 words, per byte lane x[q] bit b <-> x[b] bit q."""
    x = list(x)
    for q in range(4):
        delta_swap(x, q, q + 4, 4, 0x0F0F0F0F)
    for a, b in ((0, 2), (1, 3), (4, 6), (5, 7)):
        delta_swap(x, a, b, 2, 0x33333333)
    for q in range(0, 8, 2):
        delta_swap(x, q, q + 1, 1, 0x55555555)
    return x


def emulate_k1(matrix: np.ndarray, data: np.ndarray, R: int | None = None) -> np.ndarray:
    """gf_apply_kernel on (s, n) uint8 rows: per tile of TILE bytes, thread
    t's column is the 16 bytes at t * 16 (words 0-3) and the 16 at
    HALF_TILE + t * 16 (words 4-7), zero past n; transpose to planes, the
    table apply with offsets from the matrix, transpose back, and keep only
    the bytes inside the row."""
    r, s = matrix.shape
    n = data.shape[1]
    padded = np.zeros((s, -(-n // TILE) * TILE), np.uint8)
    padded[:, :n] = data
    # (s, tiles, piece, thread, word) -> (s, tiles, thread, piece * 4 + word)
    words = padded.view("<u4").reshape(s, -1, 2, THREADS, 4).transpose(0, 1, 3, 2, 4)
    x = torch.from_numpy(words.reshape(s, -1, THREADS, 8).astype(np.int64))
    planes = [transpose8([x[j, ..., q] for q in range(8)]) for j in range(s)]
    out = table_apply(planes, lambda o, p, j, h: k1_index(matrix, o, p, j, h),
                      r, s, R or group_rows(r))
    y = torch.stack([torch.stack(transpose8(o), dim=-1) for o in out]).numpy()
    back = y.astype(np.uint32).reshape(r, -1, THREADS, 2, 4).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(back).reshape(r, -1).view(np.uint8)[:, :n]


def _rs_jax_apply(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    width = data.shape[1]
    padded = np.zeros((data.shape[0], bitslice.padded_width(width)), dtype=np.uint8)
    padded[:, :width] = data
    words = np.asarray(rs_jax.apply_matrix(matrix, bitslice.bytes_to_words(padded)))
    return bitslice.words_to_bytes(words)[:, :width]


# -- tests ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted({**plane_matrices(), **stacks()}))
def test_k2_table_apply_matches_plain_and_pallas(name):
    mat = all_matrices()[name]
    rng = np.random.default_rng(len(name))
    words = rng.integers(0, 2**32, size=(mat.shape[1], 2 * BW), dtype=np.uint32)
    got = emulate_k2(mat, words)
    want = rs_torch.apply_matrix_planes_reference(mat, torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)
    if mat.shape[0] <= 8:  # the 12-row stack: the plain version stands alone
        np.testing.assert_array_equal(
            got, np.asarray(rs_pallas.apply_matrix_planes(mat, jnp.asarray(words), interpret=True)))


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_k2_table_apply_in_groups_of_every_size(R):
    """Output rows split over grid.y groups of R rows (the launchers' R for
    r rows is group_rows(r); here every R against the 12-row stack)."""
    mat = stacks()["rs10_4_3x4loss_stack"]
    words = np.random.default_rng(R).integers(0, 2**32, size=(10, BW), dtype=np.uint32)
    want = rs_torch.apply_matrix_planes_reference(mat, torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(emulate_k2(mat, words, R), want)


@pytest.mark.parametrize("name", sorted(all_matrices()))
def test_k1_offsets_equal_the_plane_mask_nibbles(name):
    """K1 derives its table indices from the GF(2^8) matrix inside the
    kernel; they must be the nibbles K2 gets from the host."""
    mat = all_matrices()[name]
    r, s = mat.shape
    masks = rs_cuda.pack_masks(gf256.matrix_to_gf2(mat))
    for o in range(r):
        for p in range(8):
            for j in range(s):
                for h in range(2):
                    assert k1_index(mat, o, p, j, h) == (int(masks[8 * o + p, j]) >> (4 * h)) & 15


def test_k1_offsets_for_every_coefficient():
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    masks = rs_cuda.pack_masks(gf256.matrix_to_gf2(every))
    got = np.array([[[[k1_index(every, o, p, j, h) for h in range(2)] for j in range(16)]
                     for p in range(8)] for o in range(16)])
    want = np.stack([masks & 15, masks >> 4], axis=-1).reshape(16, 8, 16, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [1, 3, 4097, 2 * TILE + 5])
@pytest.mark.parametrize("name", ["rs10_4_encode", "rs10_4_loss4", "cauchy10_4_encode", "rs4_2_loss2"])
def test_k1_fused_emulation_matches_plain_and_rs_jax(name, width):
    mat = all_matrices()[name]
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, size=(mat.shape[1], width), dtype=np.uint8)
    got = emulate_k1(mat, data)
    np.testing.assert_array_equal(
        got, rs_torch.apply_matrix_reference(mat, torch.from_numpy(data)).numpy())
    np.testing.assert_array_equal(got, _rs_jax_apply(mat, data))


@pytest.mark.parametrize("name", sorted(stacks()))
def test_k1_fused_emulation_past_8_rows(name):
    """8 rows in one group, and 12 rows in two grid.y groups that each
    re-read and re-transpose the inputs; an all-byte-values input."""
    mat = stacks()[name]
    ramp = (np.arange(2 * TILE + 5)[None, :] + 37 * np.arange(10)[:, None]) % 256
    data = ramp.astype(np.uint8)
    got = emulate_k1(mat, data)
    np.testing.assert_array_equal(
        got, rs_torch.apply_matrix_reference(mat, torch.from_numpy(data)).numpy())
    np.testing.assert_array_equal(got, _rs_jax_apply(mat, data))


def _chip_smoke():
    path = Path(rs_cuda.__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_counts_the_cheaper_gf2_program():
    """The table apply's XORs (11 per input row and half, then one per
    output plane, input row and half) when they are fewer than the set
    bits, as for the RS(10,4) encode: 860 against 1224."""
    cs = _chip_smoke()
    enc = all_matrices()["rs10_4_encode"]
    assert int(gf256.matrix_to_gf2(enc).sum()) == 1224
    assert cs.xors_per_32_bytes(enc) == 2 * 10 * (11 + 8 * 4) == 860
    one = rs_matrix.reconstruction_matrix(10, 4, _present((3,)), (3,))[0]
    assert cs.xors_per_32_bytes(one) == int(gf256.matrix_to_gf2(one).sum()) < 380


@pytest.mark.parametrize("kernel, name, mib, want", [
    ("k1", "rs10_4_encode", 6, 0.026293),
    ("k1", "rs10_4_encode", 64, 0.280455),
    ("k1", "rs10_4_loss4", 64, 0.280455),
    ("k2", "rs10_4_encode", 64, 0.280455),
    ("k2", "rs10_4_5set_stack", 64, 0.360585),
])
def test_smoke_bounds_are_set_by_bytes(kernel, name, mib, want):
    """The bounds the smoke prints for its timed shapes on an H100 SXM."""
    cs = _chip_smoke()
    bound = cs.k1_bound if kernel == "k1" else cs.k2_bound
    ms, by = bound(all_matrices()[name], mib * MIB, H100_RATES)
    assert (round(ms, 6), by) == (want, "bytes")
