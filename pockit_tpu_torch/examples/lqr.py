"""README LQR example, solved in float64.

    min  int_0^1 (q x^2 + r u^2) dt + s x_f^2 / 2
    s.t. x' = a x + b u,  x(0) = 1

Run: python -m pockit_tpu_torch.examples.lqr [--device cpu]
"""

import argparse

import numpy as np
import torch

from pockit_tpu_torch.lobatto import System, constant_guess
from pockit_tpu_torch.optimizer import ipm


def build():
    a, b, s, q, r = -1, 1, 1, 1, 0.1
    system = System(["x_f"])  # one free parameter x_f
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([a * x + b * u])
    phase.set_integral([q * x**2 + r * u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(10, 10)
    system.set_phase([phase])
    system.set_objective(phase.I[0] + s * x_f**2 / 2)
    return system, phase


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    system, phase = build()
    [var_p, var_s], info = ipm.solve(
        system, [constant_guess(phase, 0), [0.0]], device=args.device, dtype=torch.float64
    )
    print("status:", info["status_msg"].decode(), "kkt path:", info["kkt_solver"])
    print("objective:", info["obj_val"])  # 0.2319139744522318 (pockit/IPOPT)
    print("x_f:", float(var_s[0]))
    # dense interpolation for plotting/export
    t_out = np.linspace(0, 1, 101)
    x_out = var_p.V_x(t_out) @ var_p.x[0]
    u_out = var_p.V_u(t_out) @ var_p.u[0]
    print("x(0.5) =", x_out[50], " u(0.5) =", u_out[50])
    return info


if __name__ == "__main__":
    main()
