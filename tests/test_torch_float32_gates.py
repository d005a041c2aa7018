"""The float32 gates of tests/test_end_to_end/test_float32_gates.py
through the port on the CPU: bang-bang (Radau, solve -> refine -> solve),
the 15x8 LGL orbit transfer (its reduced block pads to 72), the
isoperimetric problem (a system constraint on an integral) and the
3-phase Goddard rocket with Mehrotra probing, each at the JAX gate's
tolerances.
"""

import numpy as np
import pytest
import torch

import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.radau as port_radau
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.transcription.kkt import make_block_kkt

from chip_smoke import H_STAR, U_MAX, build_goddard, build_orbit
from test_torch_radau import build_bang_bang

CPU32 = dict(device="cpu", dtype=torch.float32)


def test_float32_bang_bang_gate():
    """The reference's float32 bang-bang gate through the port: Radau 5x7,
    solve, refine, solve; objective within 5e-4 of 2 and a mesh border
    within 2e-2 of the switch."""
    system, phase, guess = build_bang_bang(port_radau)
    opts = ipm.default_options(torch.float32)
    val, info = ipm.solve(system, guess, opts, **CPU32)
    assert info["status"] == 0
    val = system.refine(val)
    val, info = ipm.solve(system, val, opts, **CPU32)
    assert info["status"] == 0
    assert info["obj_val"] == pytest.approx(2.0, abs=5e-4)
    assert np.min(np.abs(np.asarray(phase._mesh) - 0.5)) < 2e-2


def test_float32_orbit_gate():
    """The reference's float32 orbit gate through the port: the 15x8 LGL
    orbit transfer, whose reduced block pads to 72; r_f within 5e-3 of
    1.5253."""
    system, guess = build_orbit(port_lobatto, 15, 8)
    assert make_block_kkt(system).interior_pad.shape == (15, 24)
    result, info = ipm.solve(system, guess, ipm.default_options(torch.float32), **CPU32)
    assert info["status"] == 0
    assert float(result[1][0]) == pytest.approx(1.5253, abs=5e-3)


def test_float32_isoperimetric_gate():
    """A system constraint on a nonlinear-integrand integral (the
    Lagrangian head's weighting): objective within 5e-5 of the float64
    0.2515982153, within 40 iterations."""
    system = port_lobatto.System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([-x + u])
    phase.set_integral([x**2 + 0.1 * u**2, u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(6, 8)
    system.set_phase([phase])
    system.set_system_constraint([phase.I[1]], [0.0], [0.4])
    system.set_objective(phase.I[0] + x_f**2 / 2)
    _, info = ipm.solve(system, [port_lobatto.constant_guess(phase, 0), [0.0]],
                        ipm.default_options(torch.float32), **CPU32)
    assert info["status"] == 0
    assert info["obj_val"] == pytest.approx(0.2515982153, abs=5e-5)
    assert info["iterations"] <= 40


def test_float32_goddard_gate():
    """The float32 Goddard gate through the port with Mehrotra probing:
    h_f within 1e-3 of 1.012837 within 40 iterations, the pinned controls
    within 1e-6 of their pins. The options are tools/bench_gates.py's
    float32 ones for this problem (tol 5e-5, delta_w_min 1e-1), which
    chip_smoke.py phase 6 runs on the card. At the CPU gate's tol 1e-5
    without the floor the port stalls at a KKT error of about 1e-4 after
    60 iterations while the reference converges in 14: the two float32
    solves part in the first step's rounding (PERF.md, Findings)."""
    system, guess = build_goddard(port_radau)
    opts = IPOptions(tol=5e-5, max_iter=60, refine_steps=3, mu_strategy="mehrotra",
                     delta_w_min=1e-1)
    result, info = ipm.solve(system, guess, opts, **CPU32)
    assert info["status"] == 0
    assert float(result[-1][-1]) == pytest.approx(H_STAR, abs=1e-3)
    assert info["iterations"] <= 40
    assert np.max(np.abs(np.asarray(result[0].u[0]) - U_MAX)) < 1e-6
    assert np.max(np.abs(np.asarray(result[2].u[0]))) < 1e-6
