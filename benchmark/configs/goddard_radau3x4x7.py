"""``goddard_radau3x4x7`` through the port's frontend: the COPS 3.0 Goddard
rocket as three linked flipped-LGR phases (full thrust, the singular arc,
the coast), built as ``pockit_tpu_torch/examples/goddard_ascent.py`` builds
it, with the constants, mesh and guess of ``goddard_radau3x4x7.json``. One
guess (``config``), through the port's ``preprocess``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.configs import Problem


def build(cfg: dict) -> Problem:
    import sympy as sp

    from pockit_tpu_torch import radau
    from pockit_tpu_torch.optimizer._common import preprocess

    k, d = cfg["constants"], cfg["derived"]
    t_max, c_ex, d_c, m_f = float(d["T_max"]), float(d["c"]), float(d["D_c"]), float(d["m_f"])
    h0, g0, beta = float(k["h0"]), float(k["g0"]), float(k["h_c"]) / float(k["h0"])
    system = radau.System(list(cfg["statics"]))
    t_a, t_b, t_f, h_a, v_a, m_a, h_b, v_b, h_f = system.s

    def make_phase(u_lb, u_ub, bc0, bcf, t0, t1):
        ph = system.new_phase(["h", "v", "m"], ["u"])
        h, v, m = ph.x
        (u,) = ph.u
        drag = d_c * v**2 * sp.exp(-beta * (h - h0))
        ph.set_dynamics([v, (u - drag) / m - g0 * h0**2 / h**2, -u / c_ex])
        ph.set_phase_constraint([u], [u_lb], [u_ub])
        ph.set_boundary_condition(bc0, bcf, t0, t1)
        ph.set_discretization(int(cfg["intervals"]), int(cfg["points"]))
        return ph

    start = [h0, float(k["v0"]), float(k["m0"])]
    p1 = make_phase(t_max, t_max, start, [h_a, v_a, m_a], 0.0, t_a)
    p2 = make_phase(0.0, t_max, [h_a, v_a, m_a], [h_b, v_b, m_f], t_a, t_b)
    p3 = make_phase(0.0, 0.0, [h_b, v_b, m_f], [h_f, 0.0, m_f], t_b, t_f)
    system.set_phase([p1, p2, p3])
    system.set_objective(-h_f)

    guesses = []
    for ph, g in zip((p1, p2, p3), cfg["guess"]["phases"]):
        guess = radau.linear_guess(ph, 0.5)
        for i, name in enumerate(("h", "v", "m")):
            lo, hi = g[name]
            guess.x[i] = lo + (hi - lo) * ph.t_x
        guess.u[0] = float(g["u"])
        guesses.append(guess)
    config, _ = preprocess(system, guesses + [list(cfg["guess"]["statics"])])
    return Problem(system, {"config": config})


def boundary(problem: Problem, params: dict) -> tuple:
    """The fixed boundary values of each lane: phase 1's launch mass
    ``params["m0"]`` (its fixed slot 2, after h(0) and v(0)); every other
    fixed value, the pinned controls' included, as configured."""
    m0 = np.asarray(params["m0"], dtype=np.float64)
    bcs = [np.tile(cp.fixed_vals, (len(m0), 1)) for cp in problem.system.compiled.phases]
    bcs[0][:, 2] = m0
    return tuple(bcs)


def decode(problem: Problem, z: torch.Tensor) -> dict:
    """The reference's parts of lanes ``z (B, L)``: h, v and m at each
    phase's nodes between its two ends (phase after phase), u at phase 2's
    collocation nodes, and the nine statics."""
    system = problem.system
    h = lambda a: a.detach().to("cpu", torch.float64).numpy()
    out = {}
    for i, name in enumerate(("h", "v", "m")):
        out[name] = h(torch.cat([z[:, int(lp) + p.l_v[i] + 1 : int(lp) + p.r_v[i] - 1]
                                 for lp, p in zip(system.l_p, system.p)], dim=1))
    lp, p = int(system.l_p[1]), system.p[1]
    out["u"] = h(z[:, lp + p.l_v[3] : lp + p.r_v[3]])
    out["statics"] = h(z[:, system.l_s : system.r_s])
    return out
