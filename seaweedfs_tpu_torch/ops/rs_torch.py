"""PyTorch Reed-Solomon codec: the port of seaweedfs_tpu/ops/rs_jax.py.

A GF(2^8) matrix apply over shard rows is the whole device computation of
RS encode and rebuild.  This module holds the codec class with the JAX
codec's hooks (``recon_plan``, ``_apply``, ``_padded_width``) and API, and
the plain PyTorch version of the matrix apply, ``apply_matrix_reference``:
table gathers from ``gf256.MUL_TABLE`` and XOR on uint8.  It is the CPU
path and the yardstick the CUDA kernel (ops/rs_cuda.py) is held against.
The plane-resident rebuild hop's plain versions sit beside it:
``pack_words_reference`` / ``unpack_words_reference`` (byte-words to
GF(2) bit-planes and back), ``apply_bits_planes_reference`` (a GF(2)
bit-matrix applied plane by plane with XORs) and
``apply_matrix_planes_reference`` (the same for a GF(2^8) matrix's
lowering).

Layouts follow the JAX package at the word-level functions: shard rows are
(s, W) uint32 words, little-endian views of the (s, 4W) bytes.  Arithmetic
is on uint8 (torch on the CPU has no shifts or reductions on uint32).
"""

from __future__ import annotations

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_matrix

WORD_BYTES = 4
# the plane layout of seaweedfs_tpu/ops/rs_pallas.py: rows are cut into
# blocks of BLOCK_WORDS words (128 KB), and within a block the plane-
# interleaved layout holds bit-plane b in words [b*PLANE_WORDS, (b+1)*PLANE_WORDS)
PLANE_WORDS = 4096
BLOCK_WORDS = 8 * PLANE_WORDS


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a codec runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (or defaulted to) and absent — the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (-device cpu on the "
            "CLI) to run the codec on the host"
        )
    return dev


_mul_tables: dict[torch.device, torch.Tensor] = {}


def _mul_table(device: torch.device) -> torch.Tensor:
    table = _mul_tables.get(device)
    if table is None:
        table = torch.from_numpy(gf256.MUL_TABLE.copy()).to(device)
        _mul_tables[device] = table
    return table


def apply_matrix_reference(matrix: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(r, s) GF(2^8) matrix applied to (s, n) uint8 rows -> (r, n) uint8.

    out[o] = XOR_i MUL_TABLE[matrix[o, i]][data[i]], on data's device."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {matrix.shape}")
    r, s = matrix.shape
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != s:
        raise ValueError(
            f"need ({s}, n) uint8 rows, got {tuple(data.shape)} {data.dtype}"
        )
    table = _mul_table(data.device)
    out = torch.zeros((r, data.shape[1]), dtype=torch.uint8, device=data.device)
    for i in range(s):
        idx = data[i].to(torch.int32)
        for o in range(r):
            c = int(matrix[o, i])
            if c:
                out[o] ^= table[c][idx]
    return out


def check_plane_words(words: torch.Tensor) -> None:
    """What the plane functions take: (rows, W) uint32, W a multiple of
    BLOCK_WORDS."""
    if words.dtype != torch.uint32 or words.dim() != 2:
        raise ValueError(f"need (rows, W) uint32 words, got {tuple(words.shape)} {words.dtype}")
    if words.shape[1] % BLOCK_WORDS:
        raise ValueError(
            f"width {words.shape[1]} not a multiple of {BLOCK_WORDS} words "
            "(pad with pad_width_words)"
        )


def _plane_blocks(words: torch.Tensor) -> torch.Tensor:
    """(rows, W) uint32 -> (rows, W // BLOCK_WORDS, 8, 4 * PLANE_WORDS)
    uint8: each block's eight word groups (or planes) as bytes."""
    check_plane_words(words)
    rows, width = words.shape
    return words.contiguous().view(torch.uint8).reshape(
        rows, width // BLOCK_WORDS, 8, WORD_BYTES * PLANE_WORDS
    )


def _transpose_bits(words: torch.Tensor) -> torch.Tensor:
    """Per byte lane, the 8x8 bit transpose across a block's eight word
    groups: out group b, bit q = in group q, bit b.  It is its own inverse."""
    x = _plane_blocks(words)
    out = torch.zeros_like(x)
    for b in range(8):
        acc = out[:, :, b]
        for q in range(8):
            acc |= ((x[:, :, q] >> b) & 1) << q
    return out.view(words.shape[0], -1).view(torch.uint32)


def pack_words_reference(words: torch.Tensor) -> torch.Tensor:
    """(rows, W) byte-layout uint32 words -> (rows, W) plane-interleaved
    rows: within each block, plane b word g is
    OR_q ((x[q*PLANE_WORDS + g] >> b) & 0x01010101) << q.
    W must be a multiple of BLOCK_WORDS."""
    return _transpose_bits(words)


def unpack_words_reference(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_words_reference`: word q*PLANE_WORDS + g is
    OR_b ((plane_b[g] >> q) & 0x01010101) << b, the same transpose."""
    return _transpose_bits(planes)


def apply_bits_planes_reference(bits: np.ndarray, planes: torch.Tensor) -> torch.Tensor:
    """(8r, 8s) 0/1 GF(2) matrix applied to (s, W) plane-interleaved rows ->
    (r, W) plane-interleaved rows: output plane (o, b) is the XOR of the
    input planes (j, c) wherever bits[8o+b, 8j+c] is set, block by block."""
    bits = np.asarray(bits)
    if bits.ndim != 2 or bits.shape[0] % 8 or bits.shape[1] % 8:
        raise ValueError(f"need an (8r, 8s) GF(2) matrix, got shape {bits.shape}")
    r, s = bits.shape[0] // 8, bits.shape[1] // 8
    x = _plane_blocks(planes)
    if x.shape[0] != s:
        raise ValueError(f"matrix takes {s} rows, planes has {x.shape[0]}")
    out = torch.zeros((r, *x.shape[1:]), dtype=torch.uint8, device=x.device)
    for i, j in zip(*np.nonzero(bits)):
        out[i // 8, :, i % 8] ^= x[j // 8, :, j % 8]
    return out.view(r, -1).view(torch.uint32)


def apply_matrix_planes_reference(matrix: np.ndarray, planes: torch.Tensor) -> torch.Tensor:
    """(r, s) GF(2^8) matrix applied to (s, W) plane-interleaved rows ->
    (r, W) plane-interleaved rows: :func:`apply_bits_planes_reference` of
    the matrix's GF(2) lowering ``gf256.matrix_to_gf2``."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2:
        raise ValueError(f"matrix must be 2-D, got shape {matrix.shape}")
    return apply_bits_planes_reference(gf256.matrix_to_gf2(matrix), planes)


class ReedSolomonTorch:
    """Counterpart of seaweedfs_tpu.ops.rs_jax.ReedSolomonJax.

    Byte-level API on (rows, n) uint8 numpy arrays with any n; the
    device-level entry points (``encode_device``, ``reconstruct_device``)
    take host or device uint8 tensors and return device uint32 words
    without waiting, which is what lets the EC pipeline overlap host I/O
    with device work.  ``device`` defaults to CUDA (see resolve_device).
    """

    def __init__(
        self,
        data_shards: int,
        parity_shards: int,
        cauchy: bool = False,
        device: str | torch.device | None = None,
    ):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.cauchy = cauchy
        self.matrix = rs_matrix.matrix_for(data_shards, parity_shards, cauchy)
        self.device = resolve_device(device)

    # -- overridable kernel hooks (rs_cuda substitutes the CUDA kernel) ------

    def recon_plan(
        self, present: tuple[bool, ...], targets: tuple[int, ...]
    ) -> tuple[np.ndarray, tuple[int, ...], str]:
        mat, inputs = rs_matrix.reconstruction_matrix(
            self.data_shards, self.parity_shards, present, targets, self.cauchy
        )
        return mat, inputs, "global"

    def _apply(self, matrix: np.ndarray, words: torch.Tensor) -> torch.Tensor:
        """(s, W) uint32 words -> (r, W) uint32 words."""
        return apply_matrix_reference(matrix, words.view(torch.uint8)).view(
            torch.uint32
        )

    def _padded_width(self, n: int) -> int:
        return -(-n // WORD_BYTES) * WORD_BYTES

    # -- word-level ----------------------------------------------------------

    def encode_words(self, words: torch.Tensor) -> torch.Tensor:
        """(k, W) uint32 -> (m, W) uint32 parity words."""
        return self._apply(self.matrix[self.data_shards :], words)

    def _device_words(self, data) -> torch.Tensor:
        """(s, n) uint8 rows (numpy, host tensor — pinned for an async
        upload — or device tensor) -> (s, padded // 4) uint32 words on
        self.device, zero-padded past n."""
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(np.require(data, np.uint8, ["C", "W"]))
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError(f"need (rows, n) uint8, got {tuple(data.shape)} {data.dtype}")
        s, n = data.shape
        padded = self._padded_width(n)
        if padded == n and data.is_contiguous():
            dev = data.to(self.device, non_blocking=True)
        else:
            dev = torch.zeros((s, padded), dtype=torch.uint8, device=self.device)
            dev[:, :n].copy_(data, non_blocking=True)
        return dev.view(torch.uint32)

    # -- device-level --------------------------------------------------------

    def encode_device(self, data) -> torch.Tensor:
        """Dispatch encode without waiting: (k, n) uint8 -> (m, padded // 4)
        uint32 parity words on the device."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"need {self.data_shards} data rows, got {data.shape[0]}")
        return self.encode_words(self._device_words(data))

    def reconstruct_device(
        self, present: tuple[bool, ...], targets: tuple[int, ...], data
    ) -> torch.Tensor:
        """Dispatch a rebuild without waiting: ``data`` holds the plan's
        input shards (rows in ``recon_plan`` order); returns the
        (len(targets), padded // 4) uint32 words of the target shards."""
        mat, inputs, _mode = self.recon_plan(tuple(present), tuple(targets))
        if data.shape[0] != len(inputs):
            raise ValueError(f"plan reads {len(inputs)} shards, got {data.shape[0]} rows")
        return self._apply(mat, self._device_words(data))

    # -- byte-level ----------------------------------------------------------

    def encode(self, data: np.ndarray) -> np.ndarray:
        n = data.shape[1]
        out = self.encode_device(data)
        return out.view(torch.uint8)[:, :n].cpu().numpy()

    def reconstruct(
        self,
        shards: list[np.ndarray | None],
        data_only: bool = False,
        targets: tuple[int, ...] | None = None,
    ) -> list[np.ndarray]:
        """Fill missing shards from any k survivors (reference Reconstruct
        semantics incl. the ``targets`` restriction, as ReedSolomonJax)."""
        if len(shards) != self.total_shards:
            raise ValueError("need k+m shard slots")
        present = tuple(s is not None for s in shards)
        if targets is None:
            if sum(present) < self.data_shards:
                raise ValueError(
                    f"too few shards to reconstruct: {sum(present)} < "
                    f"{self.data_shards}"
                )
            limit = self.data_shards if data_only else self.total_shards
            targets = tuple(i for i in range(limit) if shards[i] is None)
        if not targets:
            return list(shards)
        mat, inputs, _mode = self.recon_plan(present, targets)
        n = next(len(s) for s in shards if s is not None)
        stacked = np.zeros((len(inputs), n), dtype=np.uint8)
        for row, i in enumerate(inputs):
            stacked[row] = shards[i]
        out_words = self._apply(mat, self._device_words(stacked))
        rebuilt = out_words.view(torch.uint8)[:, :n].cpu().numpy()
        out = list(shards)
        for row, t in enumerate(targets):
            out[t] = rebuilt[row]
        return out
