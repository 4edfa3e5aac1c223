"""Runtime GF(2) bit-matrix apply: the port of seaweedfs_tpu/parallel/gf2.py.

The sharded pipelines carry matrix rows as DATA (split over the mesh's
``shard`` axis, so each position computes only its own output rows), which
needs an apply whose GF(2) bit-matrix is a runtime operand.  In the JAX
package that is XLA (bitslice + ``fori_loop``).  Here it is the plane
kernels of ops/rs_cuda: K3 ``pack_words`` -> K2 ``apply_bits_planes`` on
masks packed straight from the bits -> K4 ``unpack_words``.  They take the
matrix as runtime data, so one build serves every bit-matrix.  On the CPU
:func:`apply_bits_reference`, a plain bit-matrix apply in torch, runs
instead.
"""

from __future__ import annotations

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda


def expand_bits(matrix: np.ndarray) -> np.ndarray:
    """Host-side: (r, s) GF(2^8) matrix -> (8r, 8s) uint32 0/1 bit-matrix."""
    return gf256.matrix_to_gf2(np.ascontiguousarray(matrix, dtype=np.uint8)).astype(np.uint32)


def _check(bits: np.ndarray, words: torch.Tensor) -> tuple[int, int]:
    if bits.ndim != 2 or bits.shape[0] % 8 or bits.shape[1] % 8:
        raise ValueError(f"need an (8r, 8s) bit-matrix, got shape {bits.shape}")
    if words.dtype != torch.uint32 or words.dim() != 2 or words.shape[0] != bits.shape[1] // 8:
        raise ValueError(
            f"need ({bits.shape[1] // 8}, W) uint32 words, got {tuple(words.shape)} {words.dtype}"
        )
    return bits.shape[0] // 8, words.shape[1]


def apply_bits_reference(bits: np.ndarray, words: torch.Tensor) -> torch.Tensor:
    """The plain version: output bit b of byte o is the XOR of input bits c
    of bytes j wherever bits[8o + b, 8j + c] is set, on the bytes of
    ``words`` (little-endian, so byte q of a word is byte 4w + q)."""
    bits = np.asarray(bits)
    r, _width = _check(bits, words)
    x = words.contiguous().view(torch.uint8)
    out = torch.zeros((r, x.shape[1]), dtype=torch.uint8, device=x.device)
    for i, j in zip(*np.nonzero(bits)):
        out[i // 8] ^= ((x[j // 8] >> int(j % 8)) & 1) << int(i % 8)
    return out.view(torch.uint32)


def apply_bits(bits: np.ndarray, words: torch.Tensor) -> torch.Tensor:
    """Apply a runtime GF(2) bit-matrix to shard rows of byte-words.

    bits: (8r, 8s) 0/1 (numpy); words: (s, W) uint32 -> (r, W) uint32, on
    words' device.  On a CUDA device W is zero-padded to whole BLOCK_WORDS
    (128 KB) blocks for the plane kernels and the result sliced back; rows
    already whole blocks, contiguous and 16-byte aligned (a column slice of
    a larger buffer at a block boundary, say) go in as they are."""
    bits = np.asarray(bits)
    _r, width = _check(bits, words)
    if words.device.type == "cpu":
        return apply_bits_reference(bits, words)
    padded = rs_cuda.pad_width_words(width)
    x = words
    if (padded != width or words.stride(1) != 1 or words.stride(0) % 4
            or words.data_ptr() % 16):
        x = torch.zeros((words.shape[0], padded), dtype=torch.uint32, device=words.device)
        x[:, :width] = words
    out = rs_cuda.unpack_words(rs_cuda.apply_bits_planes(bits, rs_cuda.pack_words(x)))
    return out if padded == width else out[:, :width]
