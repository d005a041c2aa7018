"""Plain reference of ``orbit_radau40x10``: the maximum-radius orbit transfer
(Bryson & Ho, Applied Optimal Control, 1975, sec. 2.7), transcribed by
flipped-LGR collocation in integral form and solved by Newton's method on
its KKT conditions, in plain torch.

    max  r(tf)
    s.t. r' = u,  u' = v^2 / r - 1 / r^2 + A(t) sin(phi),
         v' = -u v / r + A(t) cos(phi),  A(t) = T / (1 - mdot t),
         r(0) = r0, u(0) = 0, v(0) = 1 / sqrt(r0),
         u(tf) = 0, v(tf) = 1 / sqrt(r(tf)),  t in [0, tf]

Nodes: ``intervals`` uniform intervals of ``points`` LGR nodes each, plus
the end of the last: M = intervals * points + 1 state nodes, the control at
the M - 1 collocation nodes. Unknowns: (r, u, v) at nodes 1..M-2, phi at
nodes 0..M-2 and r_f = r(tf); node 0 holds the start and node M-1 the
terminal state (r_f, 0, 1 / sqrt(r_f)). Constraints, per interval, state
and collocation node j: ``x_j - x_end = dt (h / 2) sum_k I[j, k] f_k``.
There are no bounds, so the optimum solves the KKT equations
``grad f + J^T lam = 0, c = 0``: Newton's method on them, the Jacobian and
the Lagrangian's Hessian by ``torch.func``, one dense solve per lane and
step, lanes batched.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.reference.collocation import integration_matrix, lgr

NOMINAL = Path(__file__).resolve().parent.parent / "data" / "orbit_nominal.npz"


class Orbit:
    """The transcribed NLP of one configuration, on ``device`` in ``dtype``."""

    def __init__(self, cfg: dict, device="cpu", dtype=torch.float64):
        N, n = int(cfg["intervals"]), int(cfg["points"])
        self.N, self.n, self.M = N, n, N * n + 1
        self.T, self.mdot = float(cfg["thrust"]), float(cfg["mdot"])
        self.dt = float(cfg["tf"]) - float(cfg["t0"])
        tau, _ = lgr(n)
        h = 1.0 / N
        t = np.concatenate([(i + (tau + 1) / 2) * h for i in range(N)])
        f = lambda a: torch.as_tensor(a, device=device, dtype=dtype)
        self.acc = f(self.T / (1 - self.mdot * (float(cfg["t0"]) + self.dt * t)))
        self.Iw = f(integration_matrix(tau, tau) * self.dt * h / 2)  # (n, n)
        self.device, self.dtype = device, dtype
        self.n_w = 3 * (self.M - 2) + (self.M - 1) + 1

    def unpack(self, w, r0):
        """Full states (3, M) and controls (M - 1,) of one lane."""
        K = self.M - 2
        inner = w[: 3 * K].reshape(3, K)
        phi = w[3 * K : 3 * K + self.M - 1]
        rf = w[-1]
        one = torch.ones((), dtype=w.dtype, device=w.device)
        start = torch.stack([r0, 0 * one, torch.rsqrt(r0)])
        end = torch.stack([rf, 0 * one, torch.rsqrt(rf)])
        X = torch.cat([start[:, None], inner, end[:, None]], dim=1)
        return X, phi

    def constraints(self, w, r0):
        X, phi = self.unpack(w, r0)
        r, u, v = X[:, :-1]
        F = torch.stack([
            u,
            v * v / r - 1 / (r * r) + self.acc * torch.sin(phi),
            -u * v / r + self.acc * torch.cos(phi),
        ])  # (3, M - 1) at the collocation nodes
        N, n = self.N, self.n
        Fi = F.reshape(3, N, n)
        Xc = X[:, :-1].reshape(3, N, n)
        Xend = X[:, n::n]  # (3, N): each interval's right end
        res = Xc - Xend[:, :, None] - torch.einsum("jk,snk->snj", self.Iw, Fi)
        return res.reshape(-1)

    def kkt_residual(self, w, lam, r0):
        g = torch.zeros_like(w)
        g[-1] = -1.0
        J = torch.func.jacfwd(self.constraints)(w, r0)
        return torch.cat([g + J.T @ lam, self.constraints(w, r0)]), J

    def newton(self, w, lam, r0, max_steps=30, tol=1e-11, reg=0.0):
        """Newton's method on the KKT equations of lanes ``w (B, n_w)``,
        ``lam (B, m)``, ``r0 (B,)``, each step with backtracking on the
        residual's norm. ``reg`` > 0 adds ``min(reg, |F|) I`` to the
        Hessian block (a cold start, where it is singular); a warm start
        takes pure Newton steps. Returns ``(w, lam, residual norms (B,))``."""
        lag = lambda w_, lam_, r0_: lam_ @ self.constraints(w_, r0_)
        hess = torch.vmap(torch.func.hessian(lag), in_dims=(0, 0, 0))
        kkt = torch.vmap(self.kkt_residual, in_dims=(0, 0, 0))
        nw = w.shape[1]
        F, J = kkt(w, lam, r0)
        norm = F.abs().amax(dim=1)
        stalled = torch.zeros_like(norm, dtype=torch.bool)
        for _ in range(max_steps):
            if bool(((norm < tol) | stalled).all()):
                break
            H = hess(w, lam, r0)
            m = J.shape[1]
            K = torch.zeros(w.shape[0], nw + m, nw + m, dtype=w.dtype, device=w.device)
            K[:, :nw, :nw] = H
            if reg:
                d = torch.clamp(norm, max=reg)[:, None]
                K[:, range(nw), range(nw)] += d
            K[:, :nw, nw:] = J.transpose(1, 2)
            K[:, nw:, :nw] = J
            # one lane at a time: batched dense solves hang in some CPU builds
            step = torch.stack([torch.linalg.solve(Kb, -Fb) for Kb, Fb in zip(K, F)])
            alpha = torch.ones_like(norm)
            for _ in range(20):
                w_t = w + alpha[:, None] * step[:, :nw]
                lam_t = lam + alpha[:, None] * step[:, nw:]
                F_t, J_t = kkt(w_t, lam_t, r0)
                n_t = F_t.abs().amax(dim=1)
                bad = ~(n_t < norm) & (norm >= tol)
                if not bool(bad.any()):
                    break
                alpha = torch.where(bad, alpha / 2, alpha)
            # a lane that no step shortens has stalled: it keeps its point
            stalled = stalled | bad
            keep = stalled[:, None]
            w, lam = torch.where(keep, w, w_t), torch.where(keep, lam, lam_t)
            F, norm = torch.where(keep, F, F_t), torch.where(stalled, norm, n_t)
            J = torch.where(keep[:, :, None], J, J_t)
        return w, lam, norm

    def objective(self, w):
        return -w[:, -1]

    def parts(self, w, r0):
        """``obj``, states at nodes 1..M-2 (``r``, ``u``, ``v``), ``phi`` and
        ``r_f`` of lanes ``w``, on the host in float64."""
        K = self.M - 2
        h = lambda a: a.detach().to("cpu", torch.float64).numpy()
        inner = w[:, : 3 * K].reshape(-1, 3, K)
        return {
            "obj": h(self.objective(w)),
            "r": h(inner[:, 0]), "u": h(inner[:, 1]), "v": h(inner[:, 2]),
            "phi": h(w[:, 3 * K : 3 * K + self.M - 1]),
            "r_f": h(w[:, -1:]),
        }


def _nominal_w(orbit: Orbit, nominal: dict) -> torch.Tensor:
    K = orbit.M - 2
    w = np.concatenate([nominal["r"][1:-1], nominal["u"][1:-1], nominal["v"][1:-1],
                        nominal["phi"], [float(nominal["r_f"])]])
    assert w.shape[0] == orbit.n_w
    return torch.as_tensor(w, device=orbit.device, dtype=orbit.dtype)


def load_nominal() -> dict:
    with np.load(NOMINAL) as z:
        return {k: z[k] for k in z.files}


def solve(cfg: dict, params: dict, device="cpu", dtype=torch.float64, chunk=8) -> dict:
    """Each lane's optimum for ``params["r0"] (B,)``, by Newton's method
    from the nominal optimum (``data/orbit_nominal.npz``, made by
    :func:`make_nominal`), ``chunk`` lanes at a time. Adds ``kkt_norm``,
    each lane's final KKT residual (max norm)."""
    orbit = Orbit(cfg, device, dtype)
    nominal = load_nominal()
    w0 = _nominal_w(orbit, nominal)
    lam0 = torch.as_tensor(nominal["lam"], device=device, dtype=dtype)
    r0_all = np.asarray(params["r0"], dtype=np.float64)
    out = []
    for lo in range(0, len(r0_all), chunk):
        r0 = torch.as_tensor(r0_all[lo : lo + chunk], device=device, dtype=dtype)
        B = r0.shape[0]
        w, lam, norm = orbit.newton(w0.expand(B, -1).clone(), lam0.expand(B, -1).clone(), r0)
        p = orbit.parts(w, r0)
        p["kkt_norm"] = norm.detach().to("cpu", torch.float64).numpy()
        out.append(p)
    return {k: np.concatenate([o[k] for o in out]) for k in out[0]}


def feasibility(cfg: dict, params: dict, parts: dict, device="cpu", dtype=torch.float64,
                chunk=256) -> np.ndarray:
    """Each lane's largest constraint residual, in this transcription, at
    the solution ``parts`` (``r``, ``u``, ``v`` at nodes 1..M-2, ``phi``,
    ``r_f``) for ``params["r0"]``."""
    orbit = Orbit(cfg, device, dtype)
    w_all = np.concatenate([parts["r"], parts["u"], parts["v"], parts["phi"], parts["r_f"]],
                           axis=1)
    r0_all = np.asarray(params["r0"], dtype=np.float64)
    res = torch.vmap(orbit.constraints)
    out = []
    for lo in range(0, len(r0_all), chunk):
        w = torch.as_tensor(w_all[lo : lo + chunk], device=device, dtype=dtype)
        r0 = torch.as_tensor(r0_all[lo : lo + chunk], device=device, dtype=dtype)
        out.append(res(w, r0).abs().amax(dim=1).to("cpu", torch.float64).numpy())
    return np.concatenate(out)


def make_nominal(cfg: dict, path: Path = NOMINAL) -> dict:
    """Solve the nominal problem (r0 = 1) from the guess of the gate's
    bench: r from 1 to 1.5 linearly, u = 0.1, v = 1, phi = 0.5, r_f = 1.5,
    the multipliers 0. Newton's method on the KKT equations finds a
    stationary point, not always the maximum: where the Lagrangian's second
    derivative in a node's phi is negative (the Legendre-Clebsch condition
    fails there, and the thrust points the wrong way), that phi turns by pi
    and Newton's method runs again, until no node is left. Writes ``path``
    and returns its arrays."""
    orbit = Orbit(cfg)
    M, K = orbit.M, orbit.M - 2
    s = np.linspace(0.0, 1.0, M)
    g = np.concatenate([1.0 + 0.5 * s[1:-1], np.full(K, 0.1), np.ones(K),
                        np.full(M - 1, 0.5), [1.5]])
    w = torch.as_tensor(g, dtype=torch.float64)[None]
    lam = torch.zeros(1, 3 * (M - 1), dtype=torch.float64)
    r0 = torch.ones(1, dtype=torch.float64)
    lag = lambda w_, lam_: lam_ @ orbit.constraints(w_, r0[0])
    cols = torch.arange(3 * K, 3 * K + M - 1)
    for _ in range(20):
        w, lam, norm = orbit.newton(w, lam, r0, max_steps=200, reg=1.0)
        h_phi = torch.func.hessian(lag)(w[0], lam[0])[cols, cols]
        wrong = h_phi < 0
        if not bool(wrong.any()):
            break
        w[0, cols[wrong]] += torch.pi
    X, phi = orbit.unpack(w[0], r0[0])
    rec = {
        "r": X[0].numpy(), "u": X[1].numpy(), "v": X[2].numpy(), "phi": phi.numpy(),
        "r_f": np.float64(w[0, -1]), "lam": lam[0].numpy(), "kkt_norm": np.float64(norm[0]),
        "min_h_phi": np.float64(h_phi.min()),
    }
    np.savez(path, **rec)
    return rec


if __name__ == "__main__":
    import json

    cfg_path = Path(__file__).resolve().parent.parent / "configs" / "orbit_radau40x10.json"
    rec = make_nominal(json.loads(cfg_path.read_text()))
    print(json.dumps({"r_f": float(rec["r_f"]), "kkt_norm": float(rec["kkt_norm"]),
                      "min_h_phi": float(rec["min_h_phi"]), "published": 1.5253}))
