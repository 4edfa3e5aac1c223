"""CUDA GF(2^8) kernels: the port of seaweedfs_tpu/ops/rs_pallas.py.

- ``apply_matrix_cuda`` launches the byte-path kernel of csrc/gf_apply.cu
  (kernel K1 ``_make_kernel``).
- ``pack_words`` / ``unpack_words`` (K3 / K4) and ``apply_matrix_planes``
  / ``apply_matrices_planes`` (K2) launch the kernels of csrc/gf_planes.cu:
  the plane-resident rebuild hop that ``ReedSolomonCuda.
  reconstruct_words_multi`` wires together.  ``apply_bits_planes`` is K2
  with a GF(2) bit-matrix that need not come from GF(2^8), the runtime
  operand of parallel/gf2.apply_bits.

The sources are built by ops/_build.py at first use and bound through
ctypes; kernels run on PyTorch's current stream.  The per-matrix device
copies (K1's GF(2^8) matrix, K2's packed GF(2) masks) are cached and
metered by ops/sched_cache under the plane ``cuda``.  A CPU tensor goes to the
plain version in ops/rs_torch.py; a CUDA tensor launches the kernel or
raises.  Each kernel has a launch counter (``launches`` for K1,
``pack_launches``, ``unpack_launches``, ``plane_launches``), so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from functools import cache

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import _build, gf256, sched_cache, xor_sched
from seaweedfs_tpu_torch.ops.rs_torch import (
    BLOCK_WORDS,
    ReedSolomonTorch,
    apply_bits_planes_reference,
    apply_matrix_planes_reference,
    apply_matrix_reference,
    check_plane_words,
    pack_words_reference,
    unpack_words_reference,
)

launches = 0  # K1, gf_apply
pack_launches = 0  # K3
unpack_launches = 0  # K4
plane_launches = 0  # K2


@cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_apply")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.sw_gf_apply.argtypes = [ptr, i64, i64, ptr, i64, ptr, i64, i64, ptr]
    lib.sw_gf_apply.restype = ctypes.c_int
    lib.sw_gf_error_string.argtypes = [ctypes.c_int]
    lib.sw_gf_error_string.restype = ctypes.c_char_p
    return lib


@cache
def _planes_lib() -> ctypes.CDLL:
    lib = _build.load("gf_planes")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for fn in (lib.sw_gf_pack, lib.sw_gf_unpack):
        fn.argtypes = [ptr, i64, ptr, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
    lib.sw_gf_planes_apply.argtypes = [ptr, i64, i64, ptr, i64, ptr, i64, i64, ptr]
    lib.sw_gf_planes_apply.restype = ctypes.c_int
    lib.sw_gf_planes_error_string.argtypes = [ctypes.c_int]
    lib.sw_gf_planes_error_string.restype = ctypes.c_char_p
    return lib


def _device_matrix(kind: str, key: np.ndarray, stream: torch.cuda.Stream, build) -> torch.Tensor:
    """The device copy of ``build()``, a per-matrix host array, for a
    launch on ``stream``; cached by ``kind`` and ``key``'s bytes in
    sched_cache (plane ``cuda``), so the encode matrix and a volume's
    rebuild matrix are uploaded once.  A launch on another stream than the
    upload's (parallel/distributed_ec runs one stream per mesh position)
    marks the copy as used there, so the allocator cannot hand its memory
    out while that launch still reads it."""
    dev, home = sched_cache.get_or_build(
        "cuda", (kind, key.tobytes(), key.shape, stream.device),
        lambda: (torch.from_numpy(np.ascontiguousarray(build())).to(stream.device),
                 stream.cuda_stream),
    )
    if stream.cuda_stream != home:
        dev.record_stream(stream)
    return dev


def apply_matrix_cuda(matrix: np.ndarray, data: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(r, s) GF(2^8) matrix applied to shard rows: (s, n) uint8 -> (r, n)
    uint8, or (s, W) uint32 words -> (r, W) uint32 words.

    Rows must be contiguous; the row stride is free (views of a larger
    buffer are fine).  The output is a new contiguous tensor, or ``out``:
    an (r, n) view of the same type and device with contiguous rows and
    any row stride, written in place (a column slice of a larger result).
    A matrix past the kernel's limits (sw_gf_apply in csrc/gf_apply.cu: its table
    offsets in shared memory, its grid rows) raises RuntimeError."""
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
    r, s = matrix.shape
    dst = None
    if out is not None:
        if (out.dtype, out.device, tuple(out.shape)) != (data.dtype, data.device,
                                                         (r, data.shape[1])):
            raise ValueError(
                f"out must be ({r}, {data.shape[1]}) {data.dtype} on {data.device}, got "
                f"{tuple(out.shape)} {out.dtype} on {out.device}"
            )
        dst = out.view(torch.uint8) if words else out
    if raw.device.type == "cpu":
        res = apply_matrix_reference(matrix, raw)
        if dst is not None:
            dst.copy_(res)
            return out
        return res.view(torch.uint32) if words else res
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if raw.shape[0] != s:
        raise ValueError(f"matrix takes {s} rows, data has {raw.shape[0]}")
    n = raw.shape[1]
    if dst is None:
        dst = torch.empty((r, n), dtype=torch.uint8, device=raw.device)
    if n > 1 and (raw.stride(1) != 1 or dst.stride(1) != 1):
        raise ValueError("rows must be contiguous (unit stride along the row)")
    if r and n:
        stream = torch.cuda.current_stream(raw.device)
        mat = _device_matrix("gf_apply", matrix, stream, lambda: matrix)
        with torch.cuda.device(raw.device):
            err = _lib().sw_gf_apply(
                mat.data_ptr(), r, s, raw.data_ptr(), raw.stride(0),
                dst.data_ptr(), dst.stride(0), n, stream.cuda_stream,
            )
        if err:
            raise RuntimeError(
                f"gf_apply launch failed: {_lib().sw_gf_error_string(err).decode()}"
            )
        launches += 1
    if out is not None:
        return out
    return dst.view(torch.uint32) if words else dst


# ---- plane-resident path (K2-K4) --------------------------------------------


def pad_width_words(width: int) -> int:
    """Round a word count up to the plane kernels' block granularity."""
    return -(-width // BLOCK_WORDS) * BLOCK_WORDS


def _check_device_rows(x: torch.Tensor) -> None:
    """What the plane kernels take: (rows, W) uint32 on a CUDA device, W a
    multiple of BLOCK_WORDS, rows contiguous and 16-byte aligned."""
    check_plane_words(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.numel() and (x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16):
        raise ValueError("rows must be contiguous and 16-byte aligned")


def _launch(fn: str, *args, device: torch.device) -> None:
    lib = _planes_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(
            f"{fn} launch failed: {lib.sw_gf_planes_error_string(err).decode()}"
        )


def _transpose(fn: str, words: torch.Tensor) -> torch.Tensor:
    """Launch K3 or K4 (one transpose kernel) on device rows."""
    _check_device_rows(words)
    out = torch.empty(words.shape, dtype=torch.uint32, device=words.device)
    if words.numel():
        _launch(fn, words.data_ptr(), words.stride(0), out.data_ptr(),
                out.stride(0), words.shape[0], words.shape[1], device=words.device)
    return out


def pack_words(words: torch.Tensor) -> torch.Tensor:
    """(s, W) byte-layout uint32 rows -> (s, W) plane-interleaved rows (the
    layout apply_matrix_planes consumes).  W a BLOCK_WORDS multiple."""
    global pack_launches
    if words.device.type == "cpu":
        return pack_words_reference(words)
    out = _transpose("sw_gf_pack", words)
    if words.numel():
        pack_launches += 1
    return out


def unpack_words(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_words`."""
    global unpack_launches
    if planes.device.type == "cpu":
        return unpack_words_reference(planes)
    out = _transpose("sw_gf_unpack", planes)
    if planes.numel():
        unpack_launches += 1
    return out


def pack_masks(bits: np.ndarray) -> np.ndarray:
    """The plane kernel's matrix from an (8r, 8s) 0/1 GF(2) matrix: (8r, s)
    uint8 whose [i, j] bit c is bits[i, 8j + c]."""
    r8, s8 = bits.shape
    packed = np.packbits(
        np.asarray(bits, dtype=np.uint8).reshape(r8, s8 // 8, 8), axis=2, bitorder="little"
    )
    return np.ascontiguousarray(packed[:, :, 0])


def _check_bits(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if bits.ndim != 2 or bits.shape[0] % 8 or bits.shape[1] % 8 or bits.max(initial=0) > 1:
        raise ValueError(f"need an (8r, 8s) 0/1 GF(2) matrix, got shape {bits.shape}")
    return bits


def _apply_planes(kind: str, key: np.ndarray, masks, r: int, s: int,
                  planes: torch.Tensor) -> torch.Tensor:
    """Launch K2 with the masks that ``masks()`` packs for ``key``."""
    global plane_launches
    _check_device_rows(planes)
    if planes.shape[0] != s:
        raise ValueError(f"matrix takes {s} rows, planes has {planes.shape[0]}")
    width = planes.shape[1]
    out = torch.empty((r, width), dtype=torch.uint32, device=planes.device)
    if r and width:
        dev_masks = _device_matrix(kind, key, torch.cuda.current_stream(planes.device), masks)
        _launch("sw_gf_planes_apply", dev_masks.data_ptr(), r, s, planes.data_ptr(),
                planes.stride(0), out.data_ptr(), out.stride(0), width,
                device=planes.device)
        plane_launches += 1
    return out


def apply_matrix_planes(matrix: np.ndarray, planes: torch.Tensor) -> torch.Tensor:
    """GF(2^8) apply on PLANE-RESIDENT data: ``planes`` is (s, W) uint32
    rows in the plane-interleaved layout, the result (r, W) in the same
    layout, so chained applies never pack or unpack.  W must be a multiple
    of BLOCK_WORDS (pad via pad_width_words)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {matrix.shape}")
    if planes.device.type == "cpu":
        return apply_matrix_planes_reference(matrix, planes)
    r, s = matrix.shape
    return _apply_planes("planes", matrix, lambda: pack_masks(gf256.matrix_to_gf2(matrix)),
                         r, s, planes)


def apply_bits_planes(bits: np.ndarray, planes: torch.Tensor) -> torch.Tensor:
    """K2 with a GF(2) matrix that need not come from GF(2^8): ``bits`` is
    (8r, 8s) 0/1, output plane i the XOR of the input planes j (plane c of
    row j // 8 for j = 8 * row + c) where bits[i, j] is set.  ``planes`` as
    for :func:`apply_matrix_planes`; the result is (r, W)."""
    bits = _check_bits(bits)
    if planes.device.type == "cpu":
        return apply_bits_planes_reference(bits, planes)
    return _apply_planes("bits", bits, lambda: pack_masks(bits),
                         bits.shape[0] // 8, bits.shape[1] // 8, planes)


def apply_matrices_planes(
    matrices: list[np.ndarray], planes: torch.Tensor
) -> list[torch.Tensor]:
    """Apply SEVERAL GF(2^8) matrices over the same inputs to one
    plane-resident survivor stream in one kernel launch: the matrices are
    stacked (xor_sched.stack_matrices) and the result is sliced back into
    the per-matrix (r_i, W) plane-layout results."""
    stacked, row_counts = xor_sched.stack_matrices(matrices)
    out = apply_matrix_planes(stacked, planes)
    outs, row = [], 0
    for r in row_counts:
        outs.append(out[row : row + r])
        row += r
    return outs


class ReedSolomonCuda(ReedSolomonTorch):
    """ReedSolomonTorch with the CUDA kernels (the counterpart of
    seaweedfs_tpu.ops.rs_pallas.ReedSolomonPallas).  Rows pad only to whole
    4-byte words, not to the Pallas 128 KB block; the plane hop
    (``reconstruct_words_multi``) takes whole blocks."""

    def _apply(self, matrix: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        return apply_matrix_cuda(matrix, words)

    def reconstruct_words_multi(
        self,
        present: tuple[bool, ...],
        target_sets: list[tuple[int, ...]],
        words,
    ) -> list[torch.Tensor]:
        """Plane-resident rebuild hop: pack the survivors once, apply the
        stacked reconstruction matrices of several target sets in one
        plane kernel, unpack each result once.  ``words`` rows are the
        plan's input shards in plan order (identical for every target set,
        enforced), (s, W) uint32 with W a multiple of BLOCK_WORDS; returns
        one (len(targets), W) uint32 byte-layout tensor per target set, on
        self.device."""
        if not target_sets:
            return []
        plans = [self.recon_plan(tuple(present), tuple(ts)) for ts in target_sets]
        inputs0 = plans[0][1]
        for _mat, inputs, _mode in plans[1:]:
            if tuple(inputs) != tuple(inputs0):
                raise ValueError(
                    "reconstruct_words_multi needs every plan to consume "
                    f"the same inputs: {inputs} != {inputs0}"
                )
        if int(words.shape[0]) != len(inputs0):
            raise ValueError(
                f"words has {words.shape[0]} rows, plans consume {len(inputs0)}"
            )
        planes = pack_words(torch.as_tensor(words, device=self.device))
        outs = apply_matrices_planes([mat for mat, _inputs, _mode in plans], planes)
        return [unpack_words(o) for o in outs]
