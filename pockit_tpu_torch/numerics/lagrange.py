"""Barycentric Lagrange interpolation machinery.

Value matrices, differentiation matrices, and integration matrices over
arbitrary node sets, computed with the numerically stable barycentric form
(Berrut & Trefethen, SIAM Rev. 2004) instead of monomial-coefficient
manipulation (the reference uses ``scipy.interpolate.lagrange`` + ``polyval``,
upstream pockit ``pockit/base/variablebase.py:11-62``).
"""

from __future__ import annotations

import numpy as np

_EQ_TOL = 1e-13


def barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    """Barycentric weights ``w_j = 1 / prod_{k != j} (x_j - x_k)``."""
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    if n == 1:
        return np.ones(1)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def lagrange_values(
    eval_points: np.ndarray, nodes: np.ndarray, weights: np.ndarray | None = None
) -> np.ndarray:
    """Matrix ``V`` with ``V[k, j] = L_j(eval_points[k])`` via the barycentric
    formula, exact (0/1 rows) when an evaluation point coincides with a node.
    """
    eval_points = np.asarray(eval_points, dtype=np.float64)
    nodes = np.asarray(nodes, dtype=np.float64)
    m, n = len(eval_points), len(nodes)
    if n == 0 or m == 0:
        return np.zeros((m, n))
    if n == 1:
        return np.ones((m, 1))
    if weights is None:
        weights = barycentric_weights(nodes)

    diff = eval_points[:, None] - nodes[None, :]  # (m, n)
    exact = np.abs(diff) <= _EQ_TOL * np.maximum(1.0, np.abs(nodes[None, :]))
    # avoid division by zero on exact hits; those rows get overwritten below
    safe = np.where(exact, 1.0, diff)
    terms = weights[None, :] / safe
    V = terms / np.sum(terms, axis=1, keepdims=True)

    hit_rows = exact.any(axis=1)
    if hit_rows.any():
        V[hit_rows] = 0.0
        rows, cols = np.nonzero(exact)
        # keep only the first matching node per row
        _, first = np.unique(rows, return_index=True)
        V[rows[first], cols[first]] = 1.0
    return V


def differentiation_matrix(nodes: np.ndarray) -> np.ndarray:
    """Differentiation matrix at the nodes: ``(D @ y)[i] = p'(x_i)`` where
    ``p`` interpolates ``y`` at ``nodes``."""
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    if n == 1:
        return np.zeros((1, 1))
    w = barycentric_weights(nodes)
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    D = (w[None, :] / w[:, None]) / diff
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -np.sum(D, axis=1))
    return D


def V_interpolation(x_old: np.ndarray, x_new: np.ndarray) -> np.ndarray:
    """Value matrix with interpolation nodes ``x_old`` and evaluation nodes
    ``x_new`` (reference: ``variablebase.py:11-40``)."""
    x_old = np.asarray(x_old, dtype=np.float64)
    x_new = np.asarray(x_new, dtype=np.float64)
    if not len(x_new):
        return np.zeros((0, len(x_old)))
    if len(x_old) == 1:
        return np.ones((len(x_new), 1))
    # scale to [0, 1] for conditioning
    x_new = (x_new - x_old[0]) / (x_old[-1] - x_old[0])
    x_old = (x_old - x_old[0]) / (x_old[-1] - x_old[0])
    return lagrange_values(x_new, x_old)


def D_interpolation(x_old: np.ndarray, x_new: np.ndarray) -> np.ndarray:
    """Derivative matrix with interpolation nodes ``x_old`` and evaluation
    nodes ``x_new``: ``(D @ y)[k] = p'(x_new[k])``.

    Since ``p'`` has degree ``n - 2``, it is recovered exactly by
    interpolating the nodal derivatives: ``D = V(x_new) @ D_nodes``.
    """
    x_old = np.asarray(x_old, dtype=np.float64)
    x_new = np.asarray(x_new, dtype=np.float64)
    if not len(x_new):
        return np.zeros((0, len(x_old)))
    if len(x_old) == 1:
        return np.zeros((len(x_new), 1))
    width = x_old[-1] - x_old[0]
    xs_new = (x_new - x_old[0]) / width
    xs_old = (x_old - x_old[0]) / width
    D_nodes = differentiation_matrix(xs_old)
    return lagrange_values(xs_new, xs_old) @ D_nodes / width


def integral_matrix(nodes_in: np.ndarray, nodes_out: np.ndarray) -> np.ndarray:
    """Matrix ``I`` with ``(I @ f)[k] = ∫_{1}^{nodes_out[k]} p(t) dt`` where
    ``p`` interpolates ``f`` at ``nodes_in``.

    Note the integration runs from ``+1`` backwards (so the integral at
    ``x = 1`` is zero), matching the reference convention
    (``discretizationbase.py:98-180``). Computed by Gauss-Legendre quadrature
    of the barycentric basis, exact for the polynomial integrand.
    """
    nodes_in = np.asarray(nodes_in, dtype=np.float64)
    nodes_out = np.asarray(nodes_out, dtype=np.float64)
    n, m = len(nodes_in), len(nodes_out)
    if n == 0:
        return np.zeros((m, 0))
    if m == 0:
        return np.zeros((0, n))
    if n > 1:
        sorted_in = np.sort(nodes_in)
        if np.min(np.diff(sorted_in)) <= _EQ_TOL:
            raise ValueError("interpolation nodes must be pairwise distinct")

    w_bary = barycentric_weights(nodes_in)
    # Gauss-Legendre rule of enough points to integrate degree n-1 exactly
    q = max(30, 3 * n)
    gx, gw = np.polynomial.legendre.leggauss(q)

    I = np.zeros((m, n))
    for k in range(m):
        b = nodes_out[k]
        if abs(b - 1.0) <= _EQ_TOL:
            continue
        alpha = 0.5 * (b - 1.0)
        beta = 0.5 * (b + 1.0)
        pts = alpha * gx + beta
        I[k] = (alpha * gw) @ lagrange_values(pts, nodes_in, w_bary)
    return I


def polynomial_coefficients(nodes: np.ndarray) -> np.ndarray:
    """Coefficient matrix ``P`` such that ``P @ y`` gives the monomial
    coefficients (highest degree first, ``np.roots`` convention) of the
    polynomial interpolating ``y`` at ``nodes``.

    Used only for bang-bang switch-point root finding (reference:
    ``phasebase.py:2241-2251``); nodes are few (``n <= 12``) so the
    Vandermonde solve is well-behaved.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    # rows: [x^{n-1}, ..., x, 1] evaluated at nodes
    V = np.vander(nodes, n, increasing=False)
    return np.linalg.inv(V)
