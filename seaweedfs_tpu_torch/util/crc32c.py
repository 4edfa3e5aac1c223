"""CRC32-Castagnoli, the needle checksum: the port's counterpart of
``seaweedfs_tpu.native.crc32c``.

The JAX package computes it in its native library; the port builds its own
host source, ``csrc/crc32c.cpp`` (slicing-by-8), with g++ through
ops/_build.py at first use and binds it with ctypes.
A failed build raises: a byte loop in Python would cap reads at a few MB/s.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np


@cache
def _lib() -> ctypes.CDLL:
    from seaweedfs_tpu_torch.ops import _build

    lib = _build.load("crc32c")
    u32, i64, ptr = ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p
    lib.sw_crc32c.argtypes = [u32, ctypes.c_char_p, i64]
    lib.sw_crc32c.restype = u32
    lib.sw_crc32c_rows.argtypes = [ptr, i64, i64, i64, ptr]
    lib.sw_crc32c_rows.restype = None
    return lib


def _bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def crc32c(data: bytes | bytearray | memoryview, crc: int = 0) -> int:
    """CRC32C of ``data``, continuing from ``crc`` (incremental: crc32c(b,
    crc32c(a)) == crc32c(a + b))."""
    buf = _bytes(data)
    return _lib().sw_crc32c(crc, buf, len(buf))


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """CRC32C of each row of a 2-D uint8 array whose rows are contiguous
    (any row stride): one native call for many equal-length buffers."""
    if rows.dtype != np.uint8 or rows.ndim != 2 or (rows.shape[1] > 1 and rows.strides[1] != 1):
        raise ValueError(f"need 2-D uint8 rows with unit stride, got {rows.shape} {rows.dtype}")
    out = np.empty(rows.shape[0], dtype=np.uint32)
    if rows.shape[0]:
        _lib().sw_crc32c_rows(rows.ctypes.data, rows.shape[0], rows.strides[0], rows.shape[1],
                              out.ctypes.data)
    return out
