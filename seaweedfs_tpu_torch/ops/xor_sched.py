"""Stacking of GF(2^8) matrices for the plane kernel.

The port's copy of the part of seaweedfs_tpu/ops/xor_sched.py that the
plane-resident rebuild hop needs: :func:`stack_matrices` stacks several
matrices over the same inputs into one, which the plane kernel
(csrc/gf_planes.cu) executes in one launch after ``gf256.matrix_to_gf2``
lowers it to a GF(2) bit matrix.  The JAX package's CSE planner (Paar CSE,
dead-XOR elimination, reuse reordering) is not ported: the CUDA plane
kernel executes the bit matrix as it stands.
"""

from __future__ import annotations

import numpy as np


def stack_matrices(
    matrices: list[np.ndarray],
) -> tuple[np.ndarray, list[int]]:
    """Validate + stack GF(2^8) matrices over the SAME inputs, for
    ops/rs_cuda.apply_matrices_planes to feed to the plane kernel.
    Returns (stacked matrix, per-matrix output-row counts)."""
    if not matrices:
        raise ValueError("stack_matrices needs at least one matrix")
    widths = {np.asarray(m).shape[1] for m in matrices}
    if len(widths) != 1:
        raise ValueError(f"matrices consume different input widths: {widths}")
    stacked = np.vstack(
        [np.ascontiguousarray(m, dtype=np.uint8) for m in matrices]
    )
    return stacked, [int(np.asarray(m).shape[0]) for m in matrices]
