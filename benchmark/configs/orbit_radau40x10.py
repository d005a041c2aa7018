"""``orbit_radau40x10`` through the port's frontend: the maximum-radius orbit
transfer on a flipped-LGR mesh, with the constants of
``orbit_radau40x10.json``. Two guesses: the gate bench's (``config``) and
the nominal optimum of ``data/orbit_nominal.npz`` (``nominal``), which the
plain reference made; both go through the port's ``preprocess``."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.configs import Problem

NOMINAL = Path(__file__).resolve().parent.parent / "data" / "orbit_nominal.npz"


def build(cfg: dict) -> Problem:
    import sympy as sp

    from pockit_tpu_torch import radau
    from pockit_tpu_torch.optimizer._common import preprocess

    T, mdot = float(cfg["thrust"]), float(cfg["mdot"])
    system = radau.System(["r_f"])
    (r_f,) = system.s
    phase = system.new_phase(["r", "u", "v"], ["phi"])
    r, u, v = phase.x
    (phi,) = phase.u
    acc = T / (1 - mdot * phase.t)
    phase.set_dynamics([u, v**2 / r - 1 / r**2 + acc * sp.sin(phi),
                        -u * v / r + acc * sp.cos(phi)])
    r0 = float(cfg["r0_nominal"])
    phase.set_boundary_condition([r0, 0.0, 1 / np.sqrt(r0)], [r_f, 0.0, 1 / sp.sqrt(r_f)],
                                 float(cfg["t0"]), float(cfg["tf"]))
    phase.set_discretization(int(cfg["intervals"]), int(cfg["points"]))
    system.set_phase([phase])
    system.set_objective(-r_f)

    g = cfg["guess"]
    guess = radau.linear_guess(phase, 1.0)
    guess.x[0] = 1.0 + 0.5 * phase.t_x
    guess.x[1] = float(g["u"])
    guess.x[2] = float(g["v"])
    guess.u[0] = float(g["phi"])
    config, _ = preprocess(system, [guess, [float(g["r_f"])]])

    with np.load(NOMINAL) as nom:
        opt = radau.linear_guess(phase, 1.0)
        opt.x[0], opt.x[1], opt.x[2] = nom["r"], nom["u"], nom["v"]
        opt.u[0] = nom["phi"]
        nominal, _ = preprocess(system, [opt, [float(nom["r_f"])]])
    return Problem(system, {"config": config, "nominal": nominal})


def boundary(problem: Problem, params: dict) -> tuple:
    """The fixed boundary values of each lane: a circular start at radius
    ``params["r0"]``, r(0) = r0 and v(0) = 1 / sqrt(r0)."""
    r0 = np.asarray(params["r0"], dtype=np.float64)
    bc = np.tile(problem.system.compiled.phases[0].fixed_vals, (len(r0), 1))
    bc[:, 0] = r0
    bc[:, 2] = 1.0 / np.sqrt(r0)
    return (bc,)


def decode(problem: Problem, z: torch.Tensor) -> dict:
    """The reference's parts of lanes ``z (B, L)``: r, u, v at the nodes
    between the two ends, phi at every collocation node, the static r_f."""
    system = problem.system
    lv, rv = system.p[0].l_v, system.p[0].r_v
    h = lambda a: a.detach().to("cpu", torch.float64).numpy()
    out = {k: h(z[:, lv[i] + 1 : rv[i] - 1]) for i, k in enumerate(("r", "u", "v"))}
    out["phi"] = h(z[:, lv[3] : rv[3]])
    out["r_f"] = h(z[:, system.l_s : system.l_s + 1])
    return out
