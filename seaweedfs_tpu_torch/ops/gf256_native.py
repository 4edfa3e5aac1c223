"""GF(2^8) matrix apply on the host: the port's binding of csrc/gf256.cpp.

The counterpart of the gf256 half of seaweedfs_tpu/native/__init__.py.
The source is built by g++ through ops/_build.py at first use (into
``build/kernels/``, like csrc/crc32c.cpp) and bound with ctypes: the SSSE3
split-nibble ``pshufb`` apply, with its runtime dispatch and scalar path.
A failed build raises; there is no NumPy fallback.

- ``gf_mat_mul(a, b)``: the (r, k) x (k, n) product; inputs of any layout
  are copied to C order first.
- ``gf_mat_mul_rows(a, src_rows, out_rows)``: the same apply over per-row
  buffers (pread views in, slices of a reused buffer out), no staging
  matrix; every row must be a C-contiguous uint8 array of one length.
- ``gf_sched_apply(sched, src_rows, out_rows)``: a leaf+XOR program (the
  fields of the JAX package's ``xor_sched.HostSchedule``) over such rows.
  The port has no planner that emits such programs yet; the binding is
  held against the JAX package's programs.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np


@cache
def _lib() -> ctypes.CDLL:
    from seaweedfs_tpu_torch.ops import _build

    lib = _build.load("gf256")
    size, ptr = ctypes.c_size_t, ctypes.c_void_p
    lib.sw_gf_mat_mul.argtypes = [ptr, size, size, ptr, size, ptr]
    lib.sw_gf_mat_mul.restype = None
    lib.sw_gf_mat_mul_rows.argtypes = [ptr, size, size, ptr, size, ptr]
    lib.sw_gf_mat_mul_rows.restype = None
    lib.sw_gf_sched_apply.argtypes = [ptr, ptr, size, ptr, size, ptr, ptr, size, ptr, size, ptr]
    lib.sw_gf_sched_apply.restype = None
    return lib


def _row_pointers(rows, n: int, what: str):
    def ptr(r):
        # real raises, not asserts: a mis-sized row here is a native
        # out-of-bounds write under python -O, not a Python exception
        if r.dtype != np.uint8 or not r.flags.c_contiguous or len(r) != n:
            raise ValueError(f"{what} row must be C-contiguous uint8 of {n} bytes, got "
                             f"{r.dtype} {r.shape} contiguous={r.flags.c_contiguous}")
        return r.ctypes.data

    return (ctypes.c_void_p * len(rows))(*[ptr(r) for r in rows])


def gf_mat_mul(a, b) -> np.ndarray:
    """GF(2^8) product of uint8 matrices a (r, k) x b (k, n)."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    rows, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    n = b.shape[1]
    out = np.empty((rows, n), dtype=np.uint8)
    _lib().sw_gf_mat_mul(a.ctypes.data, rows, k, b.ctypes.data, n, out.ctypes.data)
    return out


def gf_mat_mul_rows(a, src_rows, out_rows) -> None:
    """out_rows[r] = sum over t of a[r, t] * src_rows[t], in place."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    rows, k = a.shape
    if len(src_rows) != k or len(out_rows) != rows:
        raise ValueError(f"need {k} src rows / {rows} out rows, "
                         f"got {len(src_rows)} / {len(out_rows)}")
    n = len(src_rows[0])
    src = _row_pointers(src_rows, n, "src")
    out = _row_pointers(out_rows, n, "out")
    _lib().sw_gf_mat_mul_rows(a.ctypes.data, rows, k, src, n, out)


def gf_sched_apply(sched, src_rows, out_rows) -> None:
    """out_rows[r] = XOR of the program's terms for row r over ``src_rows``
    (``sched``: leaf_coeff, leaf_src, shared_ops, row_offsets, row_terms,
    k, n_out)."""
    if len(src_rows) != sched.k or len(out_rows) != sched.n_out:
        raise ValueError(f"need {sched.k} src rows / {sched.n_out} out rows, "
                         f"got {len(src_rows)} / {len(out_rows)}")
    n_leaves, n_ops = len(sched.leaf_coeff), len(sched.shared_ops) // 2
    for i, (a, b) in enumerate(np.asarray(sched.shared_ops).reshape(-1, 2)):
        # an op may read only earlier terms: the executor fills them in order
        if max(a, b) >= n_leaves + i:
            raise ValueError(f"op {i} reads term {max(a, b)} before it exists")
    n_terms = n_leaves + n_ops
    if (len(sched.row_offsets) != sched.n_out + 1
            or (n_leaves and int(np.max(sched.leaf_src)) >= sched.k)
            or (len(sched.row_terms) and int(np.max(sched.row_terms)) >= n_terms)
            or (len(sched.row_offsets) and int(sched.row_offsets[-1]) > len(sched.row_terms))):
        raise ValueError("schedule indexes past its sources, terms or rows")
    arrays = [np.ascontiguousarray(sched.leaf_coeff, dtype=np.uint8)] + [
        np.ascontiguousarray(x, dtype=np.uint32)
        for x in (sched.leaf_src, sched.shared_ops, sched.row_offsets, sched.row_terms)]
    coeff, leaf_src, ops, row_offsets, row_terms = arrays
    n = len(src_rows[0])
    src = _row_pointers(src_rows, n, "src")
    out = _row_pointers(out_rows, n, "out")
    _lib().sw_gf_sched_apply(coeff.ctypes.data, leaf_src.ctypes.data, n_leaves, ops.ctypes.data,
                             n_ops, row_offsets.ctypes.data, row_terms.ctypes.data, sched.n_out,
                             src, n, out)
