"""Brachistochrone with free final time (BASELINE.json config 2), float64.

Minimum-time descent from (0, 0) to (2, 2) under gravity, Radau mesh, with
the solve -> check -> refine loop driving the collocation residual below
tolerance. The optimum is the cycloid; T* ~ 0.81647 for g = 10.

Run: python -m pockit_tpu_torch.examples.brachistochrone [--device cpu]
"""

import argparse

import numpy as np
import sympy as sp
import torch

import pockit_tpu_torch.radau as radau
from pockit_tpu_torch.optimizer import ipm

G, X_F, Y_F = 10.0, 2.0, 2.0


def build():
    system = radau.System(0)
    phase = system.new_phase(["x", "y", "v"], ["theta"])
    x, y, v = phase.x
    (theta,) = phase.u
    phase.set_dynamics([v * sp.sin(theta), v * sp.cos(theta), G * sp.cos(theta)])
    phase.set_integral([1])
    phase.set_phase_constraint([theta], [0.0], [np.pi])
    phase.set_boundary_condition([0.0, 0.0, 0.0], [X_F, Y_F, None], 0.0, None)
    phase.set_discretization(6, 7)
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    guess = radau.linear_guess(phase, 1.0)
    guess.x[2] = 5.0 * phase.t_x  # ramp speed: v = 0 everywhere is singular
    guess.u[0] = 1.0
    guess.t_f = 1.0
    return system, phase, guess


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(device=args.device, dtype=torch.float64)
    system, phase, guess = build()
    var, info = ipm.solve(system, guess, **kw)
    print("initial solve:", info["status_msg"].decode(), "T =", info["obj_val"])
    for round_ in range(5):
        if system.check(var):
            break
        var = system.refine(var)
        var, info = ipm.solve(system, var, **kw)
        print(f"refine round {round_}: N = {phase.N}, T = {info['obj_val']:.10f}")
    print("final time:", var.t_f - var.t_0)
    print("mesh check passed:", system.check(var))
    return var, info


if __name__ == "__main__":
    main()
