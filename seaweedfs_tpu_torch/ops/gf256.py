"""GF(2^8) arithmetic over the field used by the reference's RS codec.

The reference erasure codec (github.com/klauspost/reedsolomon v1.12.5, a port
of Backblaze's JavaReedSolomon; see the reference's go.mod and its call site
weed/storage/erasure_coding/ec_encoder.go:203) works in GF(2^8) with the
primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D) and generator 2.
Shard interoperability with the reference requires the exact same field, so
these tables replicate that construction.

Everything here is NumPy-only and serves as the host-side oracle.  This is
the port's own copy of seaweedfs_tpu/ops/gf256.py (the port imports nothing
of the JAX package); the CUDA kernel (csrc/gf_apply.cu) builds its product
rows from the same field, ops/rs_torch.apply_matrix_reference gathers
from MUL_TABLE, and ``matrix_to_gf2`` gives the GF(2) bit matrix that the
plane kernel (csrc/gf_planes.cu) and its plain version execute.
"""

from __future__ import annotations

import numpy as np

POLYNOMIAL = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
GENERATOR = 2
FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    b = 1
    for i in range(255):
        exp[i] = b
        log[b] = i
        b <<= 1
        if b & 0x100:
            b ^= POLYNOMIAL
    # duplicate so exp[log a + log b] never needs an explicit mod
    exp[255:510] = exp[0:255]
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


def _build_mul_table() -> np.ndarray:
    """Full 256x256 product table; MUL_TABLE[a, b] = a*b in GF(2^8)."""
    a = np.arange(256)
    la = LOG_TABLE[a][:, None]
    lb = LOG_TABLE[a][None, :]
    prod = EXP_TABLE[la + lb].astype(np.uint8)
    prod[0, :] = 0
    prod[:, 0] = 0
    return prod


MUL_TABLE = _build_mul_table()


def gf_mul(a: int, b: int) -> int:
    return int(MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("division by zero in GF(2^8)")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("zero has no inverse in GF(2^8)")
    return int(EXP_TABLE[(255 - LOG_TABLE[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    """a**n in GF(2^8) with the reference codec's conventions (0**0 == 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of uint8 matrices a (r,n) and b (n,c)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.shape[1] == b.shape[0]
    # products[i, k, j] = a[i, k] * b[k, j]; XOR-reduce over k
    products = MUL_TABLE[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(products, axis=1)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # pivot
        if aug[col, col] == 0:
            for r in range(col + 1, n):
                if aug[r, col] != 0:
                    aug[[col, r]] = aug[[r, col]]
                    break
            else:
                raise ValueError("singular matrix over GF(2^8)")
        inv_piv = gf_inv(int(aug[col, col]))
        aug[col] = MUL_TABLE[inv_piv][aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= MUL_TABLE[int(aug[r, col])][aug[col]]
    return aug[:, n:].copy()


def mat_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def coeff_to_gf2_block(c: int) -> np.ndarray:
    """Expand a GF(2^8) constant into its 8x8 GF(2) multiplication matrix.

    Multiplication by a constant is GF(2)-linear on the bit representation:
    c * sum_j(b_j * 2^j) = XOR_j b_j * (c * 2^j).  Block[i, j] = bit i of
    (c * 2^j), so out_bit[i] = XOR_j Block[i, j] & in_bit[j].  This is the
    bridge from the byte-wise matrices to the bit-plane kernels.
    """
    block = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf_mul(c, gf_exp(2, j))
        for i in range(8):
            block[i, j] = (prod >> i) & 1
    return block


def matrix_to_gf2(matrix: np.ndarray) -> np.ndarray:
    """Expand an (r, c) GF(2^8) matrix into its (8r, 8c) GF(2) bit matrix."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    r, c = matrix.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = coeff_to_gf2_block(
                int(matrix[i, j])
            )
    return out
