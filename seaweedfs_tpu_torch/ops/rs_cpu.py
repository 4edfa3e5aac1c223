"""Host Reed-Solomon codec on the native GF(2^8) apply (csrc/gf256.cpp).

The port of seaweedfs_tpu/ops/rs_cpu.py's ``ReedSolomonCPU``: systematic
encode (``encode``, and ``encode_rows`` into caller-owned parity rows),
``recon_plan`` and ``reconstruct`` (reference Reconstruct /
ReconstructData, incl. the ``targets`` restriction), as driven by the
reference's weed/storage/store_ec.go:390 for degraded reads.  It is the
small-read codec (ops/select.small_read_codec): degraded needle reads and
the EC scrub's repairs decode a 1 MB interval on the host, not worth a
device round trip; ops/lrc_codec.LrcCPU is its LRC(k, l, r) counterpart.
The bulk pipelines
keep the CUDA kernels, and with ``-device cpu`` the plain torch codec
(ops/rs_torch), which stays the plain version this one is held against.
The JAX codec's XOR-schedule planner (ops/xor_sched.host_plan) is not
ported: every apply here is the dense ``sw_gf_mat_mul`` sweep, whose
coefficient-1 terms already take the pure-XOR path.
"""

from __future__ import annotations

import numpy as np

from seaweedfs_tpu_torch.ops import rs_matrix
from seaweedfs_tpu_torch.ops.gf256_native import gf_mat_mul, gf_mat_mul_rows


class ReedSolomonCPU:
    def __init__(self, data_shards: int, parity_shards: int, cauchy: bool = False):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.cauchy = cauchy
        self.matrix = rs_matrix.matrix_for(data_shards, parity_shards, cauchy)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: (k, n) uint8 -> parity (m, n) uint8."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"need {self.data_shards} data rows, got {data.shape[0]}")
        return gf_mat_mul(self.matrix[self.data_shards :], data)

    def encode_rows(self, rows: list[np.ndarray], out_rows: list[np.ndarray]) -> None:
        """Zero-staging encode: parity accumulates straight into
        ``out_rows`` from per-shard row buffers; no (k, n) matrix is built."""
        gf_mat_mul_rows(self.matrix[self.data_shards :], rows, out_rows)

    def recon_plan(
        self, present: tuple[bool, ...], targets: tuple[int, ...]
    ) -> tuple[np.ndarray, tuple[int, ...], str]:
        """(matrix, input shard ids, repair mode) regenerating ``targets``
        from survivors; RS is MDS, so the mode is "global" and the inputs
        the first k present shards."""
        mat, inputs = rs_matrix.reconstruction_matrix(
            self.data_shards, self.parity_shards, present, targets, self.cauchy)
        return mat, inputs, "global"

    def reconstruct(
        self,
        shards: list[np.ndarray | None],
        data_only: bool = False,
        targets: tuple[int, ...] | None = None,
    ) -> list[np.ndarray]:
        """Fill in missing (None) shards from any k survivors; ``targets``
        restricts the regeneration to those shard ids (and defers
        feasibility to ``recon_plan``: an LRC local plan runs on < k
        inputs)."""
        if len(shards) != self.total_shards:
            raise ValueError("need k+m shard slots")
        present = tuple(s is not None for s in shards)
        if targets is None:
            if sum(present) < self.data_shards:
                raise ValueError(
                    f"too few shards to reconstruct: {sum(present)} < {self.data_shards}")
            limit = self.data_shards if data_only else self.total_shards
            targets = tuple(i for i in range(limit) if shards[i] is None)
        if not targets:
            return list(shards)
        mat, inputs, _mode = self.recon_plan(present, tuple(targets))
        rows = [np.ascontiguousarray(shards[i], dtype=np.uint8) for i in inputs]
        rebuilt = np.empty((len(targets), len(rows[0])), dtype=np.uint8)
        gf_mat_mul_rows(mat, rows, list(rebuilt))
        out = list(shards)
        for row, t in enumerate(targets):
            out[t] = rebuilt[row]
        return out

