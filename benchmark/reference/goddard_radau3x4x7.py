"""Plain reference of ``goddard_radau3x4x7``: the Goddard rocket of COPS 3.0
(Dolan, More and Munson, ANL/MCS-TM-273, 2004), transcribed as three
phases of flipped-LGR collocation in integral form and solved by a
primal-dual interior-point method on the dense KKT system, in plain torch.

    max  h(tf)
    s.t. h' = v,  v' = (u - D_c v^2 exp(-h_c (h - h0) / h0)) / m - g0 (h0 / h)^2,
         m' = -u / c,  0 <= u <= T_max,
         h(0) = h0, v(0) = v0, m(0) = m0, m(tf) = m_f

Where it departs from COPS (the configuration's ``assumed``):

- three phases in place of one: full thrust (u = T_max, a constant of the
  transcription), the singular arc (the box 0 <= u <= T_max on each
  collocation node), the coast (u = 0); nine statics ``t_a, t_b, t_f, h_a,
  v_a, m_a, h_b, v_b, h_f`` are the phases' free end times and the states
  at their joins, so the phases link through them: phase 1 runs from
  (h0, v0, m0) at 0 to (h_a, v_a, m_a) at t_a, phase 2 from there to
  (h_b, v_b, m_f) at t_b, phase 3 from there to (h_f, 0, m_f) at t_f;
- each phase on ``intervals`` uniform intervals of ``points`` flipped-LGR
  nodes of its normalized time, its dynamics scaled by its duration, in
  place of COPS's uniform steps;
- the launch mass m0 is each lane's parameter; the dry mass m_f and the
  constants D_c, c and T_max keep their values at m0 = 1.

Unknowns of a lane, with M = intervals * points + 1 nodes a phase: h, v
and m of each phase at its nodes 1..M-2 (phase after phase), u of phase 2
at its M - 1 collocation nodes, the statics. Constraints, per phase,
interval, state and collocation node j: ``x_j - x_end = T (h / 2) sum_k
I[j, k] f_k``, T the phase's duration.

The solver: a primal-dual interior-point method, Newton's method on the
equations ``grad f + J^T lam - z_l + z_u = 0, c = 0, (u - lo) z_l = mu,
(hi - u) z_u = mu``, the bound duals eliminated, one dense LU of the
(n + m) saddle matrix per lane and step, lanes batched; fraction to the
boundary on u and the duals, backtracking on the residual's 2-norm, mu
shrunk by the monotone rule down to 1e-13. The coast's mass rows are one
more than their rank (m is m_f at both ends of the coast and m' = 0), so
the solver leaves out the first of them, which the others imply. The
nominal optimum (m0 = 1, ``data/goddard_nominal.npz``) is solved from a
point that meets the constraints near the configuration's guess; each lane
follows the optimum from there to its own m0 in equal steps of m0, a
first-order predictor and Newton correctors at each. The singular arc
leaves the reduced Hessian all but singular in u (least eigenvalues near
4e-9 against 2e-3 at the nominal), so small steps in m0 keep every
corrector inside Newton's basin; u is still determined to about 1e-5.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.reference.collocation import integration_matrix, lgr

NOMINAL = Path(__file__).resolve().parent.parent / "data" / "goddard_nominal.npz"
MU_MIN = 1e-13  # the last barrier parameter: complementarity ends at rounding
PROX_SHIFT = 1e-10  # a floor under the Hessian block's pivots
STATES = ("h", "v", "m")


class Goddard:
    """The transcribed NLP of one configuration, on ``device`` in ``dtype``."""

    def __init__(self, cfg: dict, device="cpu", dtype=torch.float64):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        k, d = cfg["constants"], cfg["derived"]
        self.h0, self.v0, self.g0 = float(k["h0"]), float(k["v0"]), float(k["g0"])
        self.beta = float(k["h_c"]) / self.h0
        self.c, self.D_c = float(d["c"]), float(d["D_c"])
        self.T_max, self.m_f = float(d["T_max"]), float(d["m_f"])
        N, n = int(cfg["intervals"]), int(cfg["points"])
        self.N, self.n, self.M = N, n, N * n + 1
        tau, _ = lgr(n)
        f = lambda a: torch.as_tensor(a, device=device, dtype=dtype)
        self.Iw = f(integration_matrix(tau, tau) / (2 * N))  # (n, n), per unit duration
        K = self.M - 2
        self.n_x = 3 * 3 * K  # states of the three phases at their inner nodes
        self.iu = torch.arange(self.n_x, self.n_x + self.M - 1, device=device)
        self.n_w = self.n_x + (self.M - 1) + 9
        # the coast's mass rows are one more than their rank (m is m_f at
        # both of its ends and m' = 0): the solver leaves out the first,
        # which the others imply
        self.rows = torch.ones(3 * 3 * (self.M - 1), dtype=torch.bool, device=device)
        self.rows[2 * 3 * (self.M - 1) + 2 * (self.M - 1)] = False
        self.m = int(self.rows.sum())
        self._res = torch.vmap(self._residual)
        lag = lambda w_, lam_, m0_: lam_ @ self.solver_constraints(w_, m0_)
        self._hess = torch.vmap(torch.func.hessian(lag))

    def unpack(self, w, m0):
        """Each phase's full states (3, M), controls (M - 1,) and duration,
        and the statics, of one lane."""
        K, M = self.M - 2, self.M
        inner = w[: self.n_x].reshape(3, 3, K)
        u2 = w[self.n_x : self.n_x + M - 1]
        s = w[self.n_x + M - 1 :]
        t_a, t_b, t_f, h_a, v_a, m_a, h_b, v_b, h_f = s
        one = torch.ones((), dtype=w.dtype, device=w.device)
        ends = [
            (torch.stack([self.h0 * one, self.v0 * one, m0]), torch.stack([h_a, v_a, m_a])),
            (torch.stack([h_a, v_a, m_a]), torch.stack([h_b, v_b, self.m_f * one])),
            (torch.stack([h_b, v_b, self.m_f * one]), torch.stack([h_f, 0 * one, self.m_f * one])),
        ]
        X = [torch.cat([a[:, None], inner[p], b[:, None]], dim=1) for p, (a, b) in enumerate(ends)]
        U = [torch.full_like(u2, self.T_max), u2, torch.zeros_like(u2)]
        T = [t_a, t_b - t_a, t_f - t_b]
        return X, U, T, s

    def dynamics(self, X, u):
        h, v, m = X
        drag = self.D_c * v * v * torch.exp(-self.beta * (h - self.h0))
        return torch.stack([v, (u - drag) / m - self.g0 * self.h0**2 / (h * h), -u / self.c])

    def constraints(self, w, m0):
        X, U, T, _ = self.unpack(w, m0)
        N, n = self.N, self.n
        res = []
        for Xp, up, Tp in zip(X, U, T):
            F = self.dynamics(Xp[:, :-1], up).reshape(3, N, n)
            Xc = Xp[:, :-1].reshape(3, N, n)
            Xend = Xp[:, n::n]  # (3, N): each interval's right end
            res.append((Xc - Xend[:, :, None] - Tp * torch.einsum("jk,snk->snj", self.Iw, F))
                       .reshape(-1))
        return torch.cat(res)

    def solver_constraints(self, w, m0):
        return self.constraints(w, m0)[self.rows]

    def _residual(self, w, lam, zl, zu, m0, mu):
        """The primal-dual residual of one lane at barrier ``mu`` (0: the
        KKT conditions themselves), and the constraints' Jacobian."""
        J = torch.func.jacfwd(self.solver_constraints)(w, m0)
        r_d = J.T @ lam
        r_d = r_d.index_add(0, self.iu, zu - zl)
        r_d[-1] -= 1.0  # grad of -h_f
        u = w[self.iu]
        return torch.cat([r_d, self.solver_constraints(w, m0), u * zl - mu, (self.T_max - u) * zu - mu]), J

    def _factor(self, X, m0, J):
        """LU factors of the saddle matrix ``[[H + Sigma + PROX_SHIFT I,
        J^T], [J, 0]]`` at ``X = (w, lam, zl, zu)``."""
        w, lam, zl, zu = X
        nw, m, iu = self.n_w, self.m, self.iu
        u = w[:, iu]
        H = self._hess(w, lam, m0)
        H[:, iu, iu] += zl / u + zu / (self.T_max - u)
        Kmat = torch.zeros(w.shape[0], nw + m, nw + m, dtype=w.dtype, device=w.device)
        Kmat[:, :nw, :nw] = H
        Kmat[:, range(nw), range(nw)] += PROX_SHIFT
        Kmat[:, :nw, nw:] = J.transpose(1, 2)
        Kmat[:, nw:, :nw] = J
        if Kmat.device.type == "cuda":
            return [torch.linalg.lu_factor(Kmat)]
        # one lane at a time: batched dense factorizations hang in some CPU builds
        return [torch.linalg.lu_factor(Kb) for Kb in Kmat]

    def _direction(self, lu, X, F):
        """The Newton step ``(dw, dlam, dzl, dzu)`` at ``X`` against the
        residual ``F``, the bound duals eliminated."""
        w, _, zl, zu = X
        nw, m, K, iu = self.n_w, self.m, self.M - 1, self.iu
        r_l, r_u = F[:, nw + m : nw + m + K], F[:, nw + m + K :]
        sl, su = w[:, iu], self.T_max - w[:, iu]
        rhs = -F[:, : nw + m].clone()
        rhs[:, iu] += -r_l / sl + r_u / su
        if len(lu) == 1 and rhs.device.type == "cuda":
            step = torch.linalg.lu_solve(*lu[0], rhs[:, :, None])[:, :, 0]
        else:
            step = torch.stack([torch.linalg.lu_solve(*f, rb[:, None])[:, 0]
                                for f, rb in zip(lu, rhs)])
        du = step[:, iu]
        return step[:, :nw], step[:, nw:], (-r_l - zl * du) / sl, (-r_u + zu * du) / su

    def _max_step(self, X, dX, mu):
        """Fraction to the boundary: the largest step in (0, 1] that keeps
        u's gaps to its box and the bound duals above ``1 - tau`` of
        themselves, ``tau = max(0.99, 1 - mu)``."""
        w, _, zl, zu = X
        dw, _, dzl, dzu = dX
        tau = torch.clamp_min(1.0 - mu, 0.99)[:, None]
        u, du = w[:, self.iu], dw[:, self.iu]
        alpha = torch.ones_like(mu)
        for x, dx in ((u, du), (self.T_max - u, -du), (zl, dzl), (zu, dzu)):
            neg = dx < 0
            ratio = torch.where(neg, -tau * x / torch.where(neg, dx, -1.0), 1.0)
            alpha = torch.minimum(alpha, ratio.amin(dim=1))
        return alpha

    @staticmethod
    def _move(X, dX, alpha):
        return tuple(x + alpha[:, None] * d for x, d in zip(X, dX))

    @staticmethod
    def _pick(mask, new, old):
        return tuple(torch.where(mask[:, None], n, o) for n, o in zip(new, old))

    def ipm(self, X, m0, mu, max_steps=500, tol=1e-12):
        """The primal-dual interior-point method from ``X = (w (B, n_w),
        lam (B, m), zl, zu (B, M - 1))`` at ``m0 (B,)`` and barrier ``mu
        (B,)``: Newton steps with fraction to the boundary and backtracking
        on the residual's 2-norm; mu shrinks by the monotone rule, down to
        ``MU_MIN``, once a lane's subproblem is solved to 10 mu. Returns
        ``(X, KKT residual norms (B,))``: a lane stops once mu is at
        ``MU_MIN`` and its KKT residual under ``tol``, or when no step
        shortens its residual."""
        stalled = torch.zeros_like(mu, dtype=torch.bool)
        nc = self.n_w + self.m  # the complementarity rows follow
        F, J = self._res(*X, m0, mu)
        for _ in range(max_steps):
            kkt = torch.maximum(F[:, :nc].abs().amax(dim=1), (F[:, nc:] + mu[:, None]).abs().amax(dim=1))
            done = (mu <= MU_MIN) & (kkt < tol)
            live = ~(done | stalled)
            if not bool(live.any()):
                break
            solved = F.abs().amax(dim=1) <= 10.0 * mu
            mu_n = torch.clamp_min(torch.minimum(0.2 * mu, mu**1.5), MU_MIN)
            shrink = solved & live
            if bool(shrink.any()):
                mu = torch.where(shrink, mu_n, mu)
                F, J = self._res(*X, m0, mu)
            norm = torch.linalg.vector_norm(F, dim=1)
            dX = self._direction(self._factor(X, m0, J), X, F)
            alpha = self._max_step(X, dX, mu)
            bad, trial, F_t, J_t = live.clone(), X, F, J
            for _ in range(40):
                step = self._move(X, dX, alpha)
                F_s, J_s = self._res(*step, m0, mu)
                ok = torch.linalg.vector_norm(F_s, dim=1) <= (1.0 - 1e-4 * alpha) * norm
                trial = self._pick(bad, step, trial)
                F_t = torch.where(bad[:, None], F_s, F_t)
                J_t = torch.where(bad[:, None, None], J_s, J_t)
                bad = bad & ~ok
                if not bool(bad.any()):
                    break
                alpha = torch.where(bad, alpha / 2, alpha)
            # a lane that no step shortens has stalled: it keeps its point
            stalled = stalled | bad
            take = live & ~bad
            X = self._pick(take, trial, X)
            F = torch.where(take[:, None], F_t, F)
            J = torch.where(take[:, None, None], J_t, J)
        return X, self._res(*X, m0, torch.zeros_like(mu))[0].abs().amax(dim=1)

    def track(self, X, m0, stages=8):
        """Follow the optimum at barrier ``MU_MIN`` from ``X`` (the nominal
        optimum, m0 = 1) to each lane's ``m0 (B,)`` in ``stages`` equal
        steps of m0: at each, a first-order predictor (the Newton system
        against the residual's derivative in m0), then :meth:`ipm`'s Newton
        correctors at ``MU_MIN``. Returns ``(X, KKT residual norms
        (B,))``."""
        mu = torch.full_like(m0, MU_MIN)
        d_m0 = torch.vmap(lambda w, lam, zl, zu, m: torch.func.jvp(
            lambda mm: self._residual(w, lam, zl, zu, mm, MU_MIN)[0], (m,),
            (torch.ones_like(m),))[1])
        step = (m0 - 1.0) / stages
        for k in range(stages):
            m_k = 1.0 + step * k
            _, J = self._res(*X, m_k, mu)
            dX = self._direction(self._factor(X, m_k, J), X, d_m0(*X, m_k) * step[:, None])
            X = self._move(X, dX, self._max_step(X, dX, mu))
            X, norm = self.ipm(X, m_k + step, mu, max_steps=30)
        return X, norm

    def parts(self, w):
        """``obj``, h, v, m at each phase's inner nodes, phase 2's ``u`` and
        the ``statics`` of lanes ``w``, on the host in float64."""
        K = self.M - 2
        hst = lambda a: a.detach().to("cpu", torch.float64).numpy()
        inner = w[:, : self.n_x].reshape(-1, 3, 3, K)
        out = {"obj": hst(-w[:, -1])}
        for i, name in enumerate(STATES):
            out[name] = hst(inner[:, :, i].reshape(-1, 3 * K))
        out["u"] = hst(w[:, self.n_x : self.n_x + self.M - 1])
        out["statics"] = hst(w[:, self.n_x + self.M - 1 :])
        return out

    def pack(self, parts) -> np.ndarray:
        """Lanes ``w (B, n_w)`` from :meth:`parts`' arrays."""
        B, K = len(parts["statics"]), self.M - 2
        inner = np.stack([np.asarray(parts[name]).reshape(B, 3, K) for name in STATES], axis=2)
        return np.concatenate([inner.reshape(B, -1), parts["u"], parts["statics"]], axis=1)


def load_nominal(path: Path = NOMINAL) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def solve(cfg: dict, params: dict, device="cpu", dtype=torch.float64, chunk=256,
          nominal: Path = NOMINAL) -> dict:
    """Each lane's optimum for ``params["m0"] (B,)``, tracked from the
    nominal optimum (``nominal``, by default ``data/goddard_nominal.npz``,
    made by :func:`make_nominal`) by :meth:`Goddard.track`, ``chunk`` lanes
    at a time. Adds ``kkt_norm``, each lane's final KKT residual (max norm,
    the bound complementarity included)."""
    god = Goddard(cfg, device, dtype)
    nom = load_nominal(nominal)
    t = lambda a: torch.as_tensor(a, device=device, dtype=dtype)
    X0 = tuple(t(nom[k]) for k in ("w", "lam", "zl", "zu"))
    m0_all = np.asarray(params["m0"], dtype=np.float64)
    out = []
    for lo in range(0, len(m0_all), chunk):
        m0 = t(m0_all[lo : lo + chunk])
        X, norm = god.track(tuple(x.expand(len(m0), -1).clone() for x in X0), m0)
        p = god.parts(X[0])
        p["kkt_norm"] = norm.detach().to("cpu", torch.float64).numpy()
        out.append(p)
    return {k: np.concatenate([o[k] for o in out]) for k in out[0]}


def feasibility(cfg: dict, params: dict, parts: dict, device="cpu", dtype=torch.float64,
                chunk=1024) -> np.ndarray:
    """Each lane's largest residual, in this transcription, at the solution
    ``parts`` (h, v, m at each phase's inner nodes, phase 2's ``u``, the
    ``statics``) for ``params["m0"]``: collocation of the three phases (of
    phases 1 and 3 at their pinned thrust), their linkage through the
    statics, and the box's violation on phase 2's u."""
    god = Goddard(cfg, device, dtype)
    w_all = god.pack(parts)
    m0_all = np.asarray(params["m0"], dtype=np.float64)
    res = torch.vmap(god.constraints)
    out = []
    for lo in range(0, len(m0_all), chunk):
        w = torch.as_tensor(w_all[lo : lo + chunk], device=device, dtype=dtype)
        m0 = torch.as_tensor(m0_all[lo : lo + chunk], device=device, dtype=dtype)
        u = w[:, god.iu]
        box = torch.clamp_min(torch.maximum(-u, u - god.T_max), 0.0)
        r = torch.cat([res(w, m0).abs(), box], dim=1)
        out.append(r.amax(dim=1).to("cpu", torch.float64).numpy())
    return np.concatenate(out)


def guess(cfg: dict, god: Goddard) -> np.ndarray:
    """One lane's ``w`` from the configuration's guess: each state linear
    in the phase's normalized time, phase 2's u constant, the statics."""
    M = god.M
    tau, _ = lgr(god.n)
    s = np.concatenate([(i + (tau + 1) / 2) / god.N for i in range(god.N)] + [[1.0]])
    parts = {name: [] for name in STATES}
    for ph in cfg["guess"]["phases"]:
        for name in STATES:
            lo, hi = ph[name]
            parts[name].append((lo + (hi - lo) * s)[1 : M - 1])
    parts = {k: np.concatenate(v)[None] for k, v in parts.items()}
    parts["u"] = np.full((1, M - 1), float(cfg["guess"]["phases"][1]["u"]))
    parts["statics"] = np.asarray(cfg["guess"]["statics"], dtype=np.float64)[None]
    return god.pack(parts)[0]


def feasible_start(cfg: dict, god: Goddard) -> torch.Tensor:
    """A point that meets every constraint at m0 = 1, near the guess: t_a
    and t_b of the guess, phase 1 at full thrust, phase 2 at the constant
    thrust that burns m_a down to m_f by t_b, then Gauss-Newton (least-norm
    steps, backtracking on the residual) on the collocation equations in
    every other unknown."""
    w = torch.as_tensor(guess(cfg, god))
    m0 = torch.ones((), dtype=torch.float64)
    k = god.n_x + god.M - 1  # the first static, t_a
    t_a, t_b = float(w[k]), float(w[k + 1])
    m_a = 1.0 - god.T_max / god.c * t_a
    w[god.iu] = (m_a - god.m_f) * god.c / (t_b - t_a)
    w[k + 5] = m_a
    free = torch.ones(god.n_w, dtype=torch.bool)
    free[god.iu] = False
    free[k] = False
    for _ in range(50):
        c = god.constraints(w, m0)
        norm = float(torch.linalg.vector_norm(c))
        if norm < 1e-13:
            break
        J = torch.func.jacfwd(god.constraints)(w, m0)[:, free]
        d = torch.linalg.lstsq(J, -c[:, None], driver="gelsd").solution[:, 0]
        alpha = 1.0
        for _ in range(30):
            w_t = w.clone()
            w_t[free] += alpha * d
            if float(torch.linalg.vector_norm(god.constraints(w_t, m0))) < (1 - 1e-4 * alpha) * norm:
                break
            alpha /= 2
        w = w_t
    return w


def make_nominal(cfg: dict, path: Path = NOMINAL) -> dict:
    """Solve the nominal problem (m0 = 1) by :meth:`Goddard.ipm` from
    :func:`feasible_start`, the least-squares multipliers, barrier 1e-3 and
    the bound duals at mu over their gaps. Writes ``path`` and returns its
    arrays."""
    god = Goddard(cfg)
    w = feasible_start(cfg, god)
    m0 = torch.ones(1, dtype=torch.float64)
    g = torch.zeros(god.n_w, dtype=torch.float64)
    g[-1] = -1.0
    J = torch.func.jacfwd(god.solver_constraints)(w, m0[0])
    lam = torch.linalg.lstsq(J.T, -g[:, None], driver="gelsd").solution[:, 0]
    mu = 1e-3
    u = w[god.iu]
    X = (w[None], lam[None], (mu / u)[None], (mu / (god.T_max - u))[None])
    (w, lam, zl, zu), norm = god.ipm(X, m0, torch.full_like(m0, mu))
    rec = {"w": w[0].numpy(), "lam": lam[0].numpy(), "zl": zl[0].numpy(), "zu": zu[0].numpy(),
           "h_f": np.float64(w[0, -1]), "kkt_norm": np.float64(norm[0])}
    np.savez(path, **rec)
    return rec


if __name__ == "__main__":
    import json

    cfg_path = Path(__file__).resolve().parent.parent / "configs" / "goddard_radau3x4x7.json"
    cfg = json.loads(cfg_path.read_text())
    rec = make_nominal(cfg)
    print(json.dumps({"h_f": float(rec["h_f"]), "kkt_norm": float(rec["kkt_norm"]),
                      "published": cfg["h_f_published"]}))
