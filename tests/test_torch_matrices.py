"""The port's matrices equal the JAX package's.

The codec's state is its matrices (there are no weights to carry across),
so the port's copies of gf256 and rs_matrix must reproduce the reference
tables, encode matrices and every reconstruction matrix exactly.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_matrix as jax_rs_matrix
from seaweedfs_tpu_torch.ops import gf256, rs_matrix
from seaweedfs_tpu_torch.storage.erasure_coding.scheme import EcScheme

GEOMETRIES = [(10, 4), (6, 3), (12, 4)]


def test_field_tables_equal():
    np.testing.assert_array_equal(gf256.EXP_TABLE, jax_gf256.EXP_TABLE)
    np.testing.assert_array_equal(gf256.LOG_TABLE, jax_gf256.LOG_TABLE)
    np.testing.assert_array_equal(gf256.MUL_TABLE, jax_gf256.MUL_TABLE)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    b = rng.integers(0, 256, (9, 5), dtype=np.uint8)
    np.testing.assert_array_equal(gf256.mat_mul(a, b), jax_gf256.mat_mul(a, b))


@pytest.mark.parametrize("cauchy", [False, True], ids=["rs", "cauchy"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_matrices_equal(k, m, cauchy):
    got = rs_matrix.matrix_for(k, m, cauchy)
    np.testing.assert_array_equal(got, jax_rs_matrix.matrix_for(k, m, cauchy))
    assert not got.flags.writeable  # cached results are frozen
    np.testing.assert_array_equal(got[:k], np.eye(k, dtype=np.uint8))


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruction_matrices_equal_for_every_loss_pattern(k, m):
    """Every pattern of up to m losses; for RS(10,4) that includes all
    C(14,4) = 1001 4-loss patterns."""
    n = k + m
    count = 0
    for losses in range(1, m + 1):
        for lost in itertools.combinations(range(n), losses):
            present = tuple(i not in lost for i in range(n))
            mat, inputs = rs_matrix.reconstruction_matrix(k, m, present, lost)
            want, want_inputs = jax_rs_matrix.reconstruction_matrix(k, m, present, lost)
            assert inputs == want_inputs
            assert np.array_equal(mat, want), lost
            assert not mat.flags.writeable
            count += losses == 4 and (k, m) == (10, 4)
    if (k, m) == (10, 4):
        assert count == 1001


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruction_matrix_rebuilds_the_encode_rows(k, m):
    enc = rs_matrix.matrix_for(k, m)
    lost = tuple(range(m))  # the hardest case: the first m data shards
    present = tuple(i not in lost for i in range(k + m))
    mat, inputs = rs_matrix.reconstruction_matrix(k, m, present, lost)
    np.testing.assert_array_equal(gf256.mat_mul(mat, enc[list(inputs)]), enc[list(lost)])


def test_too_many_losses_raise():
    present = tuple(i >= 5 for i in range(14))
    with pytest.raises(ValueError):
        rs_matrix.reconstruction_matrix(10, 4, present, (0, 1, 2, 3, 4))


def test_scheme_repair_plan_uses_the_port_matrices():
    present = tuple(i not in (0, 3, 10, 13) for i in range(14))
    mat, inputs, mode = EcScheme().repair_plan(present, (0, 3, 10, 13))
    want, want_inputs = jax_rs_matrix.reconstruction_matrix(10, 4, present, (0, 3, 10, 13))
    assert (inputs, mode) == (want_inputs, "global")
    np.testing.assert_array_equal(mat, want)
