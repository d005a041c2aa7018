"""``lqr_lgl10x10`` through the port's frontend: the README LQR on an LGL
mesh, with the sizes and constants of ``lqr_lgl10x10.json``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.configs import Problem


def build(cfg: dict) -> Problem:
    from pockit_tpu_torch.lobatto import System, constant_guess
    from pockit_tpu_torch.optimizer._common import preprocess

    a, b, q, r, s = (float(cfg[k]) for k in ("a", "b", "q", "r", "s"))
    system = System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([a * x + b * u])
    phase.set_integral([q * x**2 + r * u**2])
    phase.set_boundary_condition([float(cfg["x0_nominal"])], [x_f], float(cfg["t0"]), float(cfg["tf"]))
    phase.set_discretization(int(cfg["intervals"]), int(cfg["points"]))
    system.set_phase([phase])
    system.set_objective(phase.I[0] + s * x_f**2 / 2)
    guess, _ = preprocess(system, [constant_guess(phase, 0), [0.0]])
    return Problem(system, {"config": guess})


def boundary(problem: Problem, params: dict) -> tuple:
    """The fixed boundary values of each lane: x(t0) = ``params["x0"]``."""
    x0 = np.asarray(params["x0"], dtype=np.float64)
    bc = np.tile(problem.system.compiled.phases[0].fixed_vals, (len(x0), 1))
    bc[:, 0] = x0
    return (bc,)


def decode(problem: Problem, z: torch.Tensor) -> dict:
    """The reference's parts of lanes ``z (B, L)``: x at the nodes between
    the two ends, the static x_f, and u at every node."""
    system = problem.system
    lv, rv = system.p[0].l_v, system.p[0].r_v
    h = lambda a: a.detach().to("cpu", torch.float64).numpy()
    return {
        "x": h(z[:, lv[0] + 1 : rv[0] - 1]),
        "x_f": h(z[:, system.l_s : system.l_s + 1]),
        "u": h(z[:, lv[1] : rv[1]]),
    }
