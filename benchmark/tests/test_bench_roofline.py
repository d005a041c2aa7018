"""The benchmark's own count of the factor's work, one shape by hand."""

import pytest

from benchmark import roofline


def test_cholesky_count_by_hand():
    # n = 2: column 0: sqrt (1), one entry below: a division (1);
    # column 1: its dot of one term (2) and the sqrt (1)
    assert roofline.chol_ops(2) == 1 + 1 + 3
    assert roofline.chol_ops(1) == 1


def test_factor_count_by_hand():
    """(nb, ni, nr) = (2, 2, 1): per block a Cholesky of 2 (5 operations),
    X = A^-1 B by a forward and a back substitution of one column (2 * 1 *
    2^2 = 8), the Schur update of the 1x1 corner (1 entry, a dot of 2: 2 * 2
    = 4); then the corner's Cholesky (1). Bytes, float64: per block the
    lower triangle of A (3) and B (2), the corner's triangle (1) and the
    shift (1), read; as much written."""
    assert roofline.factor_lane_ops(2, 2, 1) == 2 * (5 + 8 + 4) + 1
    assert roofline.factor_lane_bytes(2, 2, 1, 8) == 2 * (2 * (3 + 2) + 1 + 1) * 8
    b = roofline.factor_bound_s(2, 2, 1, 1000, "float64")
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx(1000 * 192 / 3.35e12)


def test_real_sizes_of_the_cells():
    """The LQR's (10, 16, 25) and the orbit's (40, 37, 126) are bound by
    their bytes at the cells' batches."""
    lqr = roofline.factor_bound_s(10, 16, 25, 16384, "float32")
    orbit = roofline.factor_bound_s(40, 37, 126, 1024, "float64")
    assert lqr["bound_by"] == orbit["bound_by"] == "bytes"
    assert lqr["bound_s"] == pytest.approx(2.2247e-4, rel=1e-4)
    assert orbit["bound_s"] == pytest.approx(1.08869e-3, rel=1e-4)
