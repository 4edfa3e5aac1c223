"""Reed-Solomon generator/decode matrices, interoperable with the reference.

The reference calls reedsolomon.New(10, 4) with default options
(weed/storage/erasure_coding/ec_encoder.go:203), which builds
a *systematic Vandermonde* matrix: an extended Vandermonde matrix
vm[r][c] = r**c (in GF(2^8)), post-multiplied by the inverse of its top
square so the first k rows become the identity.  Shards produced here are
therefore bit-compatible with shards produced by the Go codec.

RS(k, m) is first-class: the reference hard-codes 10+4 while its worker
protos already model configurable shard counts (SURVEY.md §2.4 note); here
every entry point takes (data_shards, parity_shards).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from seaweedfs_tpu_torch.ops import gf256


@lru_cache(maxsize=None)
def build_encode_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """(k+m, k) systematic encode matrix; rows 0..k-1 are the identity.

    Matches the default matrix of the reference's codec (klauspost
    reedsolomon, Vandermonde made systematic).
    """
    _validate(data_shards, parity_shards)
    total = data_shards + parity_shards
    vm = np.zeros((total, data_shards), dtype=np.uint8)
    for r in range(total):
        for c in range(data_shards):
            vm[r, c] = gf256.gf_exp(r, c)
    top_inv = gf256.mat_inv(vm[:data_shards, :data_shards])
    matrix = gf256.mat_mul(vm, top_inv)
    matrix.setflags(write=False)
    return matrix


@lru_cache(maxsize=None)
def build_cauchy_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """(k+m, k) systematic Cauchy matrix (klauspost's WithCauchyMatrix option).

    Identity on top; parity row r, column c = 1 / (r ^ c) with r ranging over
    k..k+m-1.  Offered for the configurable RS(k, m) variants; the default
    interoperable matrix is build_encode_matrix.
    """
    _validate(data_shards, parity_shards)
    total = data_shards + parity_shards
    matrix = np.zeros((total, data_shards), dtype=np.uint8)
    matrix[:data_shards] = gf256.mat_identity(data_shards)
    for r in range(data_shards, total):
        for c in range(data_shards):
            matrix[r, c] = gf256.gf_inv(r ^ c)
    matrix.setflags(write=False)
    return matrix


@lru_cache(maxsize=4096)
def decode_matrix_for(
    data_shards: int,
    parity_shards: int,
    present: tuple[bool, ...],
    cauchy: bool = False,
) -> np.ndarray:
    """(k, k) matrix mapping k chosen surviving shards -> original data shards.

    `present` flags which of the k+m shards are available; the first k present
    shards (in shard order) are the inputs, mirroring the reference codec's
    reconstruction which gathers the first k valid shards
    (klauspost reedsolomon.Reconstruct semantics, exercised from
    weed/storage/erasure_coding/ec_encoder.go:275 and
    weed/storage/store_ec.go:390).

    Cached: for RS(10,4) there are at most C(14,10)=1001 erasure patterns
    (SURVEY.md §7 hard part #5).
    """
    k = data_shards
    if len(present) != data_shards + parity_shards:
        raise ValueError("present mask length must be k+m")
    rows = [i for i, p in enumerate(present) if p][:k]
    if len(rows) < k:
        raise ValueError(
            f"need at least {k} shards to reconstruct, have {sum(present)}"
        )
    enc = matrix_for(data_shards, parity_shards, cauchy)
    sub = enc[rows, :]
    inv = gf256.mat_inv(sub)
    inv.setflags(write=False)
    return inv


def matrix_for(data_shards: int, parity_shards: int, cauchy: bool = False) -> np.ndarray:
    """Single point of matrix-variant selection used across the codecs."""
    return (
        build_cauchy_matrix(data_shards, parity_shards)
        if cauchy
        else build_encode_matrix(data_shards, parity_shards)
    )


@lru_cache(maxsize=4096)
def reconstruction_matrix(
    data_shards: int,
    parity_shards: int,
    present: tuple[bool, ...],
    targets: tuple[int, ...],
    cauchy: bool = False,
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Matrix computing the `targets` shards from the first k present shards.

    Returns (matrix of shape (len(targets), k), input_shard_ids).  Data-shard
    targets come straight from the decode matrix; parity targets compose the
    decode matrix with the encode rows (recover data first, then re-encode),
    exactly the strategy of the reference codec's Reconstruct.

    Cached (and the matrix frozen) like decode_matrix_for: the rebuild
    pipeline derives its plan once per volume, and the CUDA wrapper's
    device-matrix cache keys on these exact bytes.
    """
    k = data_shards
    enc = matrix_for(data_shards, parity_shards, cauchy)
    inputs = tuple(i for i, p in enumerate(present) if p)[:k]
    dec = decode_matrix_for(data_shards, parity_shards, present, cauchy)
    out_rows = []
    for t in targets:
        if t < k:
            out_rows.append(dec[t])
        else:
            out_rows.append(gf256.mat_mul(enc[t : t + 1], dec)[0])
    mat = np.stack(out_rows).astype(np.uint8)
    mat.setflags(write=False)
    return mat, inputs


def _validate(data_shards: int, parity_shards: int) -> None:
    if data_shards <= 0 or parity_shards <= 0:
        raise ValueError("data_shards and parity_shards must be positive")
    if data_shards + parity_shards > 256:
        raise ValueError("total shards must be <= 256 over GF(2^8)")
