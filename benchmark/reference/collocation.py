"""Collocation tables of the plain references, worked out from the textbook
definitions with numpy's Legendre series alone.

- LGL(n), Legendre-Gauss-Lobatto on [-1, 1]: -1, the roots of P'_{n-1}, +1;
  weights 2 / (n (n - 1) P_{n-1}(x)^2).
- LGR(n), flipped Legendre-Gauss-Radau on [-1, 1): -1 and the roots of
  (P_{n-1} + P_n) / (1 + x); weights (1 - x) / (n P_{n-1}(x))^2.
- The integration matrix of the integral form of collocation:
  ``I[j, k] = int_{+1}^{rows[j]} l_k(s) ds``, with ``l_k`` the Lagrange basis
  on ``nodes``; so ``x(rows[j]) - x(+1) = (h / 2) sum_k I[j, k] f_k`` on an
  interval of length ``h`` where ``x' = f``.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre as leg


def _p(n: int) -> np.ndarray:
    c = np.zeros(n + 1)
    c[n] = 1.0
    return c


def _polish(roots: np.ndarray, series: np.ndarray) -> np.ndarray:
    """Newton steps on a Legendre series at its (real) roots."""
    d = leg.legder(series)
    x = np.sort(np.real(roots))
    for _ in range(8):
        x = x - leg.legval(x, series) / leg.legval(x, d)
    return x


def lgl(n: int) -> tuple[np.ndarray, np.ndarray]:
    """LGL nodes and weights, ``n >= 2``."""
    inner = _polish(leg.legroots(leg.legder(_p(n - 1))), leg.legder(_p(n - 1))) if n > 2 else []
    x = np.concatenate([[-1.0], inner, [1.0]])
    w = 2.0 / (n * (n - 1) * leg.legval(x, _p(n - 1)) ** 2)
    return x, w


def lgr(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Flipped LGR nodes (``-1`` included, ``+1`` not) and weights."""
    s = leg.legadd(_p(n - 1), _p(n))
    roots = leg.legroots(s)
    inner = _polish(roots[np.abs(roots + 1.0) > 1e-6], s)
    x = np.concatenate([[-1.0], inner])
    w = (1.0 - x) / (n * leg.legval(x, _p(n - 1))) ** 2
    return x, w


def integration_matrix(nodes: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``I[j, k] = int_{+1}^{rows[j]} l_k(s) ds`` for the Lagrange basis on
    ``nodes``, through the Legendre coefficients of each basis polynomial."""
    n = len(nodes)
    V = leg.legvander(nodes, n - 1)  # V[i, m] = P_m(nodes[i])
    C = np.linalg.solve(V, np.eye(n))  # column k: Legendre coefficients of l_k
    out = np.empty((len(rows), n))
    for k in range(n):
        c = leg.legint(C[:, k])
        out[:, k] = leg.legval(rows, c) - leg.legval(1.0, c)
    return out
