"""Three-phase rocket ascent (Goddard problem, normalized units),
BASELINE.json config 4: linked phases with linkage conditions and path
constraints, float64.

    max h(t_f)
    h' = v,  v' = (u - D(h, v)) / m - 1 / h^2,  m' = -u / c
    D(h, v) = D0 v^2 exp(-beta (h - 1)),  0 <= u <= u_max
    h(0) = 1, v(0) = 0, m(0) = 1, m(t_f) = 0.6

The optimal thrust is bang-singular-bang: full thrust, a singular arc, then
coast. Phase boundaries are free (statics t_a, t_b, t_f); states link
through statics via FUNC boundary conditions. The classic optimum for
these parameters is h* ~ 1.01284.

Run: python -m pockit_tpu_torch.examples.goddard_ascent [--device cpu]
"""

import argparse

import sympy as sp
import torch

import pockit_tpu_torch.radau as radau
from pockit_tpu_torch.optimizer import ipm

U_MAX, C_EX, D0, BETA = 3.5, 0.5, 310.0, 500.0
M0, MF = 1.0, 0.6
NAMES = ["t_a", "t_b", "t_f", "h_a", "v_a", "m_a", "h_b", "v_b", "h_f"]


def build():
    system = radau.System(NAMES)
    t_a, t_b, t_f, h_a, v_a, m_a, h_b, v_b, h_f = system.s

    def make_phase(u_lb, u_ub, bc0, bcf, t0, t1):
        ph = system.new_phase(["h", "v", "m"], ["u"])
        h, v, m = ph.x
        (u,) = ph.u
        drag = D0 * v**2 * sp.exp(-BETA * (h - 1))
        ph.set_dynamics([v, (u - drag) / m - 1 / h**2, -u / C_EX])
        ph.set_phase_constraint([u], [u_lb], [u_ub])
        ph.set_boundary_condition(bc0, bcf, t0, t1)
        ph.set_discretization(4, 7)
        return ph

    # full thrust; the singular arc (free thrust) burning the remaining
    # fuel; the coast to the apex
    p1 = make_phase(U_MAX, U_MAX, [1.0, 0.0, M0], [h_a, v_a, m_a], 0.0, t_a)
    p2 = make_phase(0.0, U_MAX, [h_a, v_a, m_a], [h_b, v_b, MF], t_a, t_b)
    p3 = make_phase(0.0, 0.0, [h_b, v_b, MF], [h_f, 0.0, MF], t_b, t_f)
    system.set_phase([p1, p2, p3])
    system.set_objective(-h_f)

    guesses = []
    for ph, (h0, h1), (vv0, vv1), (mm0, mm1), uu in [
        (p1, (1.0, 1.005), (0.0, 0.1), (1.0, 0.8), U_MAX),
        (p2, (1.005, 1.01), (0.1, 0.05), (0.8, MF), 1.0),
        (p3, (1.01, 1.013), (0.05, 0.0), (MF, MF), 0.0),
    ]:
        g = radau.linear_guess(ph, 0.5)
        g.x[0] = h0 + (h1 - h0) * ph.t_x
        g.x[1] = vv0 + (vv1 - vv0) * ph.t_x
        g.x[2] = mm0 + (mm1 - mm0) * ph.t_x
        g.u[0] = uu
        guesses.append(g)
    statics0 = [0.023, 0.068, 0.2, 1.005, 0.1, 0.8, 1.01, 0.05, 1.0128]
    return system, guesses + [statics0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    system, guess = build()
    result, info = ipm.solve(system, guess, device=args.device, dtype=torch.float64)
    print("status:", info["status_msg"].decode(), "kkt path:", info["kkt_solver"])
    statics = result[-1]
    for n, v_ in zip(NAMES, statics):
        print(f"  {n} = {float(v_):.6f}")
    print("max altitude:", float(statics[-1]), "(classic optimum ~1.01284)")
    return result, info


if __name__ == "__main__":
    main()
