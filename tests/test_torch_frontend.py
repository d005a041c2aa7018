"""The port's frontend against the JAX package: the sympy lowering, the
static problem layout, and that the port never loads jax.

Both packages are imported in this process (jax on the CPU, as the
conftest sets it); data passes between them as numpy.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
from pockit_tpu.base.expr import LoweredFunc as RefLowered
from pockit_tpu.transcription.kkt import make_block_kkt as ref_block_kkt
from pockit_tpu_torch.base.expr import LoweredFunc as PortLowered
from pockit_tpu_torch.base.expr import _fold_extreme_exp_coeffs
from pockit_tpu_torch.transcription.kkt import make_block_kkt as port_block_kkt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_lqr(mod, mesh=10, num_point=10):
    """The README LQR, built through either package's ``lobatto``."""
    system = mod.System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([-x + u])
    phase.set_integral([x**2 + 0.1 * u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(mesh, num_point)
    system.set_phase([phase])
    system.set_objective(phase.I[0] + x_f**2 / 2)
    return system, phase


_h, _v, _x, _y = sp.symbols("h v x y")
_EXPRS = {
    "poly_trig": (sp.exp(_x) * _y**2 + sp.sin(_y), [_x, _y]),
    # sympy splits e^500 out: the folded (_exp_folded) lowering path
    "exp_fold": (310.0 * _v**2 * sp.exp(-500.0 * (_h - 1)), [_v, _h]),
    "rational": (1 / (1 + _x**2) - 0.25 * sp.cos(3 * _x), [_x]),
    "constant": (sp.Float(2.5), [_x]),
}


@pytest.mark.parametrize("name", sorted(_EXPRS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_lowered_func_matches_reference(name, dtype):
    expr, syms = _EXPRS[name]
    rng = np.random.default_rng(0)
    vals = [rng.uniform(0.98, 1.02, 7).astype(dtype) for _ in syms]
    want = np.asarray(RefLowered(expr, syms)([jnp.asarray(v) for v in vals]))
    port = PortLowered(expr, syms)
    got_t = port([torch.as_tensor(v) for v in vals])
    got_np = port(vals)  # numpy arguments, as phase.py passes them
    assert got_t.dtype == torch.from_numpy(vals[0]).dtype
    assert got_t.shape == want.shape == (7,)
    # same float math in another library: rounding-level agreement (the
    # folded exp's argument is ~500, which scales its rounding ~500x)
    rtol = 2e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got_t.numpy(), want, rtol=rtol)
    np.testing.assert_allclose(np.asarray(got_np), want, rtol=rtol)


def test_exp_fold_removes_float32_overflow():
    expr = 310.0 * sp.exp(-500.0 * (_h - 1))
    folded = _fold_extreme_exp_coeffs(expr)
    assert not any(abs(float(a)) > 1e30 for a in folded.atoms(sp.Float))
    got = PortLowered(expr, [_h])([torch.tensor([1.0, 1.013], dtype=torch.float32)])
    # float32 evaluation of a folded exp: a few ulps
    np.testing.assert_allclose(
        got.numpy(), 310.0 * np.exp(-500.0 * (np.array([1.0, 1.013]) - 1)), rtol=2e-5
    )


@pytest.mark.parametrize("mesh", [6, 10])
def test_static_layout_matches_reference(mesh):
    ref_sys, _ = build_lqr(ref_lobatto, mesh, mesh)
    port_sys, _ = build_lqr(port_lobatto, mesh, mesh)
    rc, pc = ref_sys.compiled, port_sys.compiled
    assert (rc.L, rc.m) == (pc.L, pc.m)
    for name in ("z_lb", "z_ub", "c_lb", "c_ub"):
        np.testing.assert_array_equal(getattr(rc, name), getattr(pc, name))
    for rp, pp in zip(rc.phases, pc.phases):
        np.testing.assert_array_equal(rp.fixed_idx, pp.fixed_idx)
        np.testing.assert_array_equal(rp.fixed_vals, pp.fixed_vals)
    rb, pb = ref_block_kkt(ref_sys), port_block_kkt(port_sys)
    np.testing.assert_array_equal(rb.interior_pad, pb.interior_pad)
    np.testing.assert_array_equal(rb.layout.reduced, pb.layout.reduced)
    assert rb.layout.krylov_rank == pb.layout.krylov_rank == 0


def test_port_never_imports_jax():
    script = """
import sys
import pockit_tpu_torch.lobatto as lobatto
from pockit_tpu_torch.optimizer import ipm
assert "jax" not in sys.modules, "importing the port loaded jax"
system = lobatto.System(["x_f"])
(x_f,) = system.s
phase = system.new_phase(["x"], ["u"])
(x,) = phase.x
(u,) = phase.u
phase.set_dynamics([-x + u])
phase.set_integral([x**2 + 0.1 * u**2])
phase.set_boundary_condition([1], [x_f], 0, 1)
phase.set_discretization(4, 5)
system.set_phase([phase])
system.set_objective(phase.I[0] + x_f**2 / 2)
import torch
_, info = ipm.solve(system, [lobatto.constant_guess(phase, 0), [0.0]], device="cpu",
                     dtype=torch.float64)
assert info["status"] == 0, info
assert "jax" not in sys.modules, "a CPU solve loaded jax"
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_variable_interpolation_matches_reference():
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    port_sys, port_phase = build_lqr(port_lobatto, 6, 6)
    ref_v = ref_lobatto.linear_guess(ref_phase, 0.5)
    port_v = port_lobatto.linear_guess(port_phase, 0.5)
    np.testing.assert_array_equal(port_v.data, ref_v.data)
    t = np.linspace(0.0, 1.0, 17)
    for name in ("V_x", "V_u", "D_x", "D_u"):
        np.testing.assert_array_equal(getattr(port_v, name)(t), getattr(ref_v, name)(t))
