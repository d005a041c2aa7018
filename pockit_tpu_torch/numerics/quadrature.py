"""Legendre-Gauss-Lobatto and Legendre-Gauss-Radau nodes and weights.

Built from Gauss-Jacobi roots via Golub-Welsch (``scipy.special.roots_jacobi``)
plus a Newton polish on the defining polynomial — numerically tighter than
companion-matrix root finding on raw coefficients (which is what the
reference uses, upstream pockit ``pockit/lobatto/discretization.py:80-110``,
upstream pockit ``pockit/radau/discretization.py:89-114``).

Node families (reference interval ``[-1, 1]``):

- LGL(n):  ``{-1} ∪ roots(P'_{n-1}) ∪ {+1}``, weights
  ``w_i = 2 / (n (n-1) P_{n-1}(x_i)^2)``.
- LGR(n) (left-sided): ``{-1} ∪ roots(P^{(0,1)}_{n-1})``, weights
  ``w_i = (1 - x_i) / (n P_n(x_i))^2`` evaluated with the normalized
  Legendre polynomial — algebraically ``(1 - x_i) / (n^2 P_{n-1}(x_i)^2)``.
"""

from __future__ import annotations

import functools

import numpy as np
from numpy.polynomial import legendre as npleg
from scipy.special import roots_jacobi


def _legval(x: np.ndarray, n: int) -> np.ndarray:
    """Evaluate Legendre polynomial P_n at x."""
    c = np.zeros(n + 1)
    c[n] = 1.0
    return npleg.legval(x, c)


def _legderval(x: np.ndarray, n: int) -> np.ndarray:
    """Evaluate d/dx P_n at x."""
    c = np.zeros(n + 1)
    c[n] = 1.0
    return npleg.legval(x, npleg.legder(c))


@functools.lru_cache(maxsize=None)
def xw_lgl(num_point: int) -> tuple[np.ndarray, np.ndarray]:
    """LGL nodes and quadrature weights on ``[-1, 1]``.

    Computed by the port's C++ library (``csrc/colloc.cpp``, see
    :mod:`~pockit_tpu_torch.numerics.native`) when available, else the
    scipy/numpy path (:func:`_lgl_numpy`); both use Golub-Welsch
    Jacobi-matrix eigenvalues and agree to ~1e-14 (weights of many LGR
    points to ~2e-13: the C++ LGR nodes get no Newton polish).

    ``num_point == 1`` degenerates to the midpoint rule ``([0], [2])`` to
    match the reference's convention.
    """
    if num_point <= 0:
        raise ValueError("at least one interpolation point is required")
    from pockit_tpu_torch.numerics import native

    res = native.lgl(num_point)
    return res if res is not None else _lgl_numpy(num_point)


def _lgl_numpy(num_point: int) -> tuple[np.ndarray, np.ndarray]:
    """The scipy/numpy path of :func:`xw_lgl`."""
    if num_point == 1:
        return np.array([0.0]), np.array([2.0])
    n = num_point - 1  # polynomial degree
    if num_point == 2:
        interior = np.array([])
    else:
        # roots of P'_n are the Gauss-Jacobi(1,1) nodes of degree n-1
        interior, _ = roots_jacobi(n - 1, 1.0, 1.0)
        # Newton polish on P'_n: x <- x - P'_n(x) / P''_n(x)
        for _ in range(2):
            c = np.zeros(n + 1)
            c[n] = 1.0
            d1 = npleg.legval(interior, npleg.legder(c))
            d2 = npleg.legval(interior, npleg.legder(c, 2))
            interior = interior - d1 / d2
    x = np.concatenate(([-1.0], np.sort(interior), [1.0]))
    w = 2.0 / (n * (n + 1) * _legval(x, n) ** 2)
    return x, w


@functools.lru_cache(maxsize=None)
def xw_lgr(num_point: int) -> tuple[np.ndarray, np.ndarray]:
    """Left LGR nodes (include -1, exclude +1) and quadrature weights on
    ``[-1, 1]`` (native C++ when available, see :func:`xw_lgl`)."""
    if num_point <= 0:
        raise ValueError("at least one interpolation point is required")
    from pockit_tpu_torch.numerics import native

    res = native.lgr(num_point)
    return res if res is not None else _lgr_numpy(num_point)


def _lgr_numpy(num_point: int) -> tuple[np.ndarray, np.ndarray]:
    """The scipy/numpy path of :func:`xw_lgr`."""
    if num_point == 1:
        return np.array([-1.0]), np.array([2.0])
    interior, _ = roots_jacobi(num_point - 1, 0.0, 1.0)
    # Newton polish on q(x) = (P_{n-1}(x) + P_n(x)) / (1 + x), whose roots are
    # the interior LGR nodes; equivalently polish on P^{(0,1)}_{n-1} via
    # r(x) = P_{n-1}(x) + P_n(x):   r(x) = (1 + x) * const * P^{(0,1)}_{n-1}(x)
    n = num_point
    for _ in range(2):
        r = _legval(interior, n - 1) + _legval(interior, n)
        dr = _legderval(interior, n - 1) + _legderval(interior, n)
        interior = interior - r / dr
    x = np.concatenate(([-1.0], np.sort(interior)))
    w = (1.0 - x) / (num_point * _legval(x, num_point)) ** 2
    return x, w
