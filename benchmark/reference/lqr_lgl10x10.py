"""Plain reference of ``lqr_lgl10x10``: the README LQR, transcribed by LGL
collocation in integral form and solved as the quadratic program it is.

    min  int_t0^tf (q x^2 + r u^2) dt + s x_f^2 / 2
    s.t. x' = a x + b u,  x(t0) = x0,  x(tf) = x_f free

Nodes: ``intervals`` uniform intervals of ``points`` LGL nodes, shared at the
borders (M = intervals (points - 1) + 1 nodes). Unknowns: x at nodes 1..M-1
(the last is x_f) and u at every node. The objective is the LGL quadrature of
the integrand plus the terminal term; the constraints are, per interval and
per node j but the last, ``x_j - x_end = dt (h / 2) sum_k I[j, k] f_k``.

The KKT system does not depend on x0, and x0 enters only its right-hand
side, so the optimum is linear in x0 and its objective is x0^2 times the
objective at x0 = 1: one float64 solve gives every lane.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.collocation import integration_matrix, lgl


def _qp(cfg: dict):
    """(H, A, a0, W, M): objective Hessian over the unknowns, constraint
    matrix over them, the x0 column, the quadrature weights, node count."""
    N, n = int(cfg["intervals"]), int(cfg["points"])
    a, b, q, r, s = (float(cfg[k]) for k in ("a", "b", "q", "r", "s"))
    dt = float(cfg["tf"]) - float(cfg["t0"])
    x_n, w_n = lgl(n)
    Imat = integration_matrix(x_n, x_n[:-1])
    M = N * (n - 1) + 1
    h = 1.0 / N
    W = np.zeros(M)
    rows = []
    for i in range(N):
        idx = i * (n - 1) + np.arange(n)
        W[idx] += dt * w_n * h / 2
        for j in range(n - 1):
            cx = np.zeros(M)
            cu = np.zeros(M)
            cx[idx[j]] += 1.0
            cx[idx[-1]] -= 1.0
            cx[idx] -= dt * h / 2 * Imat[j] * a
            cu[idx] -= dt * h / 2 * Imat[j] * b
            rows.append(np.concatenate([cx, cu]))
    full = np.array(rows)  # columns: x_0..x_{M-1}, u_0..u_{M-1}
    a0 = full[:, 0]
    A = full[:, 1:]
    H = np.diag(np.concatenate([2 * q * W[1:], 2 * r * W]))
    H[M - 2, M - 2] += s  # x_f = x_{M-1}, the last state unknown
    return H, A, a0, W, M


def unit_solution(cfg: dict) -> dict:
    """The optimum at x0 = 1: ``obj``, ``x`` (states at nodes 1..M-2),
    ``x_f``, ``u`` (every node)."""
    H, A, a0, W, M = _qp(cfg)
    nw, m = H.shape[0], A.shape[0]
    K = np.zeros((nw + m, nw + m))
    K[:nw, :nw] = H
    K[:nw, nw:] = A.T
    K[nw:, :nw] = A
    rhs = np.concatenate([np.zeros(nw), -a0])
    sol = np.linalg.solve(K, rhs)
    w = sol[:nw]
    xs = np.concatenate([[1.0], w[: M - 1]])
    u = w[M - 1 :]
    obj = float(np.sum(W * (float(cfg["q"]) * xs**2 + float(cfg["r"]) * u**2))
                + float(cfg["s"]) * xs[-1] ** 2 / 2)
    return {"obj": obj, "x": xs[1:-1], "x_f": xs[-1], "u": u}


def solve(cfg: dict, params: dict, device=None) -> dict:
    """Every lane's optimum for ``params["x0"] (B,)``: ``obj (B,)``, ``x (B,
    M-2)``, ``x_f (B, 1)``, ``u (B, M)``; on the host, whatever ``device``."""
    x0 = np.asarray(params["x0"], dtype=np.float64)
    one = unit_solution(cfg)
    return {
        "obj": one["obj"] * x0**2,
        "x": x0[:, None] * one["x"][None, :],
        "x_f": x0[:, None] * one["x_f"],
        "u": x0[:, None] * one["u"][None, :],
    }
