"""Locally-repairable-code (LRC) matrices over the RS codec's GF(2^8).

The port's own copy of seaweedfs_tpu/ops/lrc_matrix.py (the port imports
nothing of the JAX package), on the port's ops/gf256.py.

Azure-style LRC(k, l, r) (Huang et al., "Erasure Coding in Windows Azure
Storage"): k data shards split into l local groups of g = k/l, one XOR
local parity per group, and r global Reed-Solomon parities.  Shard order is
``[data 0..k-1, local parities k..k+l-1, global parities k+l..k+l+r-1]`` so
the systematic striped layout is byte-identical to RS(k, m) with m = l + r.

A single lost shard repairs from its local group only (g reads instead of
k: 5 against 10 for LRC(10,2,2)), while multi-loss patterns fall back to a
global decode over k linearly independent survivor rows.  LRC is NOT MDS:
a few > r+1-loss patterns concentrated in one group are unrecoverable;
:func:`classify_loss_patterns` counts them.

Everything here is NumPy-only host algebra; the CUDA kernels (ops/rs_cuda)
take these matrices as runtime data, as they take the RS ones.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import combinations

import numpy as np

from seaweedfs_tpu_torch.ops import gf256


class UnrecoverableError(ValueError):
    """The surviving shards span rank < k: no decode exists."""


def _validate(k: int, l: int, r: int) -> None:  # noqa: E741 — l is the LRC term of art
    if k <= 0 or l <= 0 or r <= 0:
        raise ValueError("LRC needs positive k, l, r")
    if k % l:
        raise ValueError(f"data shards {k} not divisible into {l} local groups")
    if k + l + r > 256:
        raise ValueError("total shards must be <= 256 over GF(2^8)")


@lru_cache(maxsize=None)
def build_lrc_matrix(k: int, l: int, r: int) -> np.ndarray:  # noqa: E741
    """(k+l+r, k) systematic LRC encode matrix.

    Rows 0..k-1: identity.  Row k+j (local parity of group j): 1 on group
    j's columns, 0 elsewhere — the XOR parity.  Row k+l+j (global parity
    j): alpha_c**(j+1) with alpha_c = 2**c.  Powers START AT 1: a power-0
    row would be all-ones, linearly dependent with the XOR local parities.
    Any within-group loss submatrix is then [all-ones; alpha_c; alpha_c^2;
    ...], a Vandermonde over distinct alpha, hence invertible.
    """
    _validate(k, l, r)
    g = k // l
    matrix = np.zeros((k + l + r, k), dtype=np.uint8)
    matrix[:k] = gf256.mat_identity(k)
    for j in range(l):
        matrix[k + j, j * g : (j + 1) * g] = 1
    for j in range(r):
        for c in range(k):
            matrix[k + l + j, c] = gf256.gf_exp(gf256.gf_exp(2, c), j + 1)
    matrix.setflags(write=False)
    return matrix


def group_of(k: int, l: int, shard_id: int) -> int | None:  # noqa: E741
    """Local group of a shard: data shards and local parities belong to
    one; global parities to none (they repair only via global decode)."""
    g = k // l
    if shard_id < k:
        return shard_id // g
    if shard_id < k + l:
        return shard_id - k
    return None


def group_members(k: int, l: int, group: int) -> tuple[int, ...]:  # noqa: E741
    """All shards of one group: its g data shards plus its local parity."""
    g = k // l
    return tuple(range(group * g, (group + 1) * g)) + (k + group,)


@lru_cache(maxsize=4096)
def local_repair_matrix(
    k: int, l: int, r: int, target: int  # noqa: E741
) -> tuple[np.ndarray, tuple[int, ...]]:
    """(1, g) matrix rebuilding ``target`` from its group co-members.

    Derived, not hard-coded: restrict the group's encode rows to the
    group's data columns (a (g, g) square: identity rows minus the target
    plus the all-ones parity row, invertible) and solve c @ enc[inputs] ==
    enc[target].  For the XOR construction c is all ones."""
    grp = group_of(k, l, target)
    if grp is None:
        raise ValueError(f"shard {target} has no local group")
    enc = build_lrc_matrix(k, l, r)
    inputs = tuple(s for s in group_members(k, l, grp) if s != target)
    g = k // l
    cols = list(range(grp * g, (grp + 1) * g))
    inv = gf256.mat_inv(enc[list(inputs)][:, cols])
    coeffs = gf256.mat_mul(enc[target : target + 1][:, cols], inv)
    coeffs.setflags(write=False)
    return coeffs, inputs


@lru_cache(maxsize=65536)
def select_decode_rows(
    k: int, l: int, r: int, present: tuple[bool, ...]  # noqa: E741
) -> tuple[np.ndarray, tuple[int, ...]]:
    """Pick k linearly independent survivor rows and invert them.

    An LRC survivor subset can be singular even when the full survivor set
    has rank k, so "first k present" (the RS rule) does not do: a greedy
    scan in shard order keeps data (identity) rows preferred.  Raises
    :class:`UnrecoverableError` when the survivors span rank < k.  Returns
    (decode (k, k) matrix mapping the chosen inputs to the data shards,
    chosen shard ids)."""
    _validate(k, l, r)
    if len(present) != k + l + r:
        raise ValueError("present mask length must be k+l+r")
    enc = build_lrc_matrix(k, l, r)
    chosen: list[int] = []
    # incremental GF(2^8) row-echelon basis over candidate rows
    basis = np.zeros((0, k), dtype=np.uint8)
    pivots: list[int] = []
    for sid in range(k + l + r):
        if not present[sid] or len(chosen) == k:
            continue
        row = enc[sid].copy()
        for b, p in zip(basis, pivots):
            if row[p]:
                row ^= gf256.MUL_TABLE[int(row[p])][
                    gf256.MUL_TABLE[gf256.gf_inv(int(b[p]))][b]
                ]
        nz = np.nonzero(row)[0]
        if nz.size == 0:
            continue  # dependent on rows already chosen
        chosen.append(sid)
        basis = np.concatenate([basis, row[None, :]])
        pivots.append(int(nz[0]))
    if len(chosen) < k:
        raise UnrecoverableError(
            f"LRC({k},{l},{r}): survivors span rank {len(chosen)} < {k}"
        )
    dec = gf256.mat_inv(enc[chosen])
    dec.setflags(write=False)
    return dec, tuple(chosen)


@lru_cache(maxsize=65536)
def reconstruction_plan(
    k: int, l: int, r: int,  # noqa: E741
    present: tuple[bool, ...],
    targets: tuple[int, ...],
) -> tuple[np.ndarray, tuple[int, ...], str]:
    """Matrix computing ``targets`` from surviving shards, cheapest first.

    Returns (matrix (len(targets), n_inputs), input shard ids, mode).  Mode
    "local": every target repairs inside its own group (all its co-members
    survive); the inputs are the union of the needed group members.  Mode
    "global": decode rows from :func:`select_decode_rows`, targets
    re-encoded from the recovered data.  Raises :class:`UnrecoverableError`
    when neither applies."""
    _validate(k, l, r)
    if len(present) != k + l + r:
        raise ValueError("present mask length must be k+l+r")
    if any(present[t] for t in targets):
        raise ValueError("targets must be missing shards")
    enc = build_lrc_matrix(k, l, r)

    # local plan: every target's co-members present (targets in distinct
    # groups by construction: two losses in one group defeat its parity)
    local_rows: list[tuple[np.ndarray, tuple[int, ...]]] = []
    for t in targets:
        grp = group_of(k, l, t)
        if grp is None or not all(
            present[s] for s in group_members(k, l, grp) if s != t
        ):
            local_rows = []
            break
        local_rows.append(local_repair_matrix(k, l, r, t))
    if local_rows and targets:
        inputs = tuple(sorted({s for _, ins in local_rows for s in ins}))
        pos = {s: i for i, s in enumerate(inputs)}
        mat = np.zeros((len(targets), len(inputs)), dtype=np.uint8)
        for row, (coeffs, ins) in enumerate(local_rows):
            for c, s in zip(coeffs[0], ins):
                mat[row, pos[s]] = c
        mat.setflags(write=False)
        return mat, inputs, "local"

    dec, inputs = select_decode_rows(k, l, r, present)
    out_rows = [
        dec[t] if t < k else gf256.mat_mul(enc[t : t + 1], dec)[0]
        for t in targets
    ]
    mat = np.stack(out_rows).astype(np.uint8) if targets else np.zeros(
        (0, len(inputs)), dtype=np.uint8
    )
    mat.setflags(write=False)
    return mat, inputs, "global"


def recoverable(k: int, l: int, r: int, present: tuple[bool, ...]) -> bool:  # noqa: E741
    """True iff the survivors span the full data space (rank k)."""
    try:
        select_decode_rows(k, l, r, present)
        return True
    except UnrecoverableError:
        return False


def classify_loss_patterns(k: int, l: int, r: int, max_losses: int | None = None):  # noqa: E741
    """Count every loss pattern of size <= max_losses (default l+r) by
    repair class: ``local`` (all targets group-repairable), ``global``
    (decodable but needs the wide decode), ``unrecoverable`` (rank < k).
    Returns {class: count}."""
    _validate(k, l, r)
    total = k + l + r
    if max_losses is None:
        max_losses = l + r
    counts = {"local": 0, "global": 0, "unrecoverable": 0}
    for n in range(1, max_losses + 1):
        for lost in combinations(range(total), n):
            present = tuple(i not in lost for i in range(total))
            try:
                _, _, mode = reconstruction_plan(k, l, r, present, lost)
                counts[mode] += 1
            except UnrecoverableError:
                counts["unrecoverable"] += 1
    return counts
