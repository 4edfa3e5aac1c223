"""CUDA GF(2^8) matrix apply: the port of seaweedfs_tpu/ops/rs_pallas.py
(byte path, kernel K1 ``_make_kernel``).

``apply_matrix_cuda`` launches the hand-written kernel of csrc/gf_apply.cu
(built by ops/_build.py at first use, bound through ctypes) on PyTorch's
current stream.  A CPU tensor goes to the plain version,
``rs_torch.apply_matrix_reference``; a CUDA tensor launches the kernel or
raises.  ``launches`` counts the kernel launches, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from functools import cache

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.ops.rs_torch import ReedSolomonTorch, apply_matrix_reference

MAX_SHARED_BYTES = 232448  # the most dynamic shared memory a block may use
_MATRIX_CACHE_SIZE = 64

launches = 0
_matrices: OrderedDict[tuple, torch.Tensor] = OrderedDict()


@cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_apply")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.sw_gf_apply.argtypes = [ptr, i64, i64, ptr, i64, ptr, i64, i64, ptr]
    lib.sw_gf_apply.restype = ctypes.c_int
    lib.sw_gf_error_string.argtypes = [ctypes.c_int]
    lib.sw_gf_error_string.restype = ctypes.c_char_p
    return lib


def _device_matrix(matrix: np.ndarray, device: torch.device) -> torch.Tensor:
    """Device copy of a matrix, cached by its bytes (LRU, bounded): the
    encode matrix and a volume's rebuild matrix are uploaded once."""
    key = (matrix.tobytes(), matrix.shape, device.index)
    dev = _matrices.get(key)
    if dev is None:
        dev = torch.from_numpy(matrix.copy()).to(device)
        _matrices[key] = dev
        if len(_matrices) > _MATRIX_CACHE_SIZE:
            _matrices.popitem(last=False)
    else:
        _matrices.move_to_end(key)
    return dev


def apply_matrix_cuda(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(r, s) GF(2^8) matrix applied to shard rows: (s, n) uint8 -> (r, n)
    uint8, or (s, W) uint32 words -> (r, W) uint32 words.

    Rows must be contiguous; the row stride is free (views of a larger
    buffer are fine).  The output is a new contiguous tensor."""
    global launches
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {matrix.shape}")
    if data.dtype not in (torch.uint8, torch.uint32) or data.dim() != 2:
        raise ValueError(
            f"need (s, n) uint8 or (s, W) uint32 rows, got {tuple(data.shape)} "
            f"{data.dtype}"
        )
    words = data.dtype == torch.uint32
    raw = data.view(torch.uint8) if words else data
    if raw.device.type == "cpu":
        out = apply_matrix_reference(matrix, raw)
        return out.view(torch.uint32) if words else out
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    r, s = matrix.shape
    if raw.shape[0] != s:
        raise ValueError(f"matrix takes {s} rows, data has {raw.shape[0]}")
    if raw.shape[1] > 1 and raw.stride(1) != 1:
        raise ValueError("rows must be contiguous (unit stride along the row)")
    if r * s * 256 > MAX_SHARED_BYTES:
        raise ValueError(f"a {r}x{s} matrix's product rows exceed shared memory")
    n = raw.shape[1]
    out = torch.empty((r, n), dtype=torch.uint8, device=raw.device)
    if r and n:
        mat = _device_matrix(matrix, raw.device)
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        with torch.cuda.device(raw.device):
            err = _lib().sw_gf_apply(
                mat.data_ptr(), r, s, raw.data_ptr(), raw.stride(0),
                out.data_ptr(), out.stride(0), n, stream,
            )
        if err:
            raise RuntimeError(
                f"gf_apply launch failed: {_lib().sw_gf_error_string(err).decode()}"
            )
        launches += 1
    return out.view(torch.uint32) if words else out


class ReedSolomonCuda(ReedSolomonTorch):
    """ReedSolomonTorch with the CUDA kernel as the matrix apply (the
    counterpart of seaweedfs_tpu.ops.rs_pallas.ReedSolomonPallas).  Rows
    pad only to whole 4-byte words, not to the Pallas 128 KB block."""

    def _apply(self, matrix: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        return apply_matrix_cuda(matrix, words)
