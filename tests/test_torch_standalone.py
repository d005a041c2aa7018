"""The port stands on its own: importing it (every module, its examples,
adapters, homotopy and profiling included, and ``chip_smoke.py`` and
``kernel_ab.py``) loads neither ``jax`` nor any module of the JAX
package; its copies of the plain-numpy numerics, discretization blocks
and mesh planner match the JAX package's; and its entry points ask for
the CUDA card unless the caller passes ``device="cpu"``.

Tolerance of the numerics comparison: atol 1e-13. Both packages take
their nodes from their copies of one C++ library where it builds (bit for
bit alike, ``tests/test_torch_unrolled.py``), else from the numpy path.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import pockit_tpu.base.discretization as ref_disc
import pockit_tpu.base.refine_discontinuous as ref_refine
import pockit_tpu.numerics as ref_num
import pockit_tpu_torch.base.discretization as port_disc
import pockit_tpu_torch.base.refine_discontinuous as port_refine
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.numerics as port_num
from pockit_tpu_torch import interop
from pockit_tpu_torch.optimizer import ipm, ipopt, scipy
from pockit_tpu_torch.parallel import homotopy_sweep, instance_mesh, solve_refine_batch
from pockit_tpu_torch.utils import aot
from pockit_tpu_torch.transcription.error import make_error_stats

from test_torch_frontend import build_lqr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-13

_IMPORT_ALL = """
import importlib.util, pkgutil, sys
import pockit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pockit_tpu_torch.__path__, "pockit_tpu_torch.")]
assert {"pockit_tpu_torch.optimizer.ipopt", "pockit_tpu_torch.optimizer.scipy",
        "pockit_tpu_torch.parallel.homotopy", "pockit_tpu_torch.utils.profiling",
        "pockit_tpu_torch.examples.mpc_sweep", "pockit_tpu_torch.examples.lqr",
        "pockit_tpu_torch.examples.brachistochrone",
        "pockit_tpu_torch.examples.goddard_ascent", "pockit_tpu_torch.parallel.distributed",
        "pockit_tpu_torch.parallel.sharding", "pockit_tpu_torch.utils.aot",
        "pockit_tpu_torch.examples.serving_aot",
        "pockit_tpu_torch.numerics.native"} <= set(names), names
for name in names:
    importlib.import_module(name)
for script in ("chip_smoke", "kernel_ab"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # defines main(); the __main__ guard keeps it from running
    assert callable(mod.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "pockit_tpu" or m.startswith("pockit_tpu."))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    count, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 20  # every module of the package was imported
    assert bad == "[]", f"importing the port loaded {bad}"


@pytest.mark.parametrize("n", range(3, 21))
@pytest.mark.parametrize("family", ["xw_lgl", "xw_lgr"])
def test_nodes_and_weights_match_reference(family, n):
    x, w = getattr(port_num, family)(n)
    x_r, w_r = getattr(ref_num, family)(n)
    np.testing.assert_allclose(x, x_r, rtol=0, atol=ATOL)
    np.testing.assert_allclose(w, w_r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_old, n_new", [(4, 9), (7, 13), (12, 5)])
def test_lagrange_matrices_match_reference(n_old, n_new):
    x_old, _ = port_num.xw_lgl(n_old)
    x_old = 0.3 + 0.8 * (x_old + 1.0)  # an interval away from [-1, 1]
    x_new = np.linspace(x_old[0] - 0.1, x_old[-1] + 0.1, n_new)
    x_new[1] = x_old[2]  # an evaluation point on a node: the exact 0/1 row
    for name in ("V_interpolation", "D_interpolation"):
        np.testing.assert_allclose(
            getattr(port_num, name)(x_old, x_new), getattr(ref_num, name)(x_old, x_new),
            rtol=0, atol=ATOL,
        )
    x, _ = port_num.xw_lgr(n_old)
    for got, want in (
        (port_num.differentiation_matrix(x), ref_num.differentiation_matrix(x)),
        (port_num.integral_matrix(x, x_new / 3), ref_num.integral_matrix(x, x_new / 3)),
        (port_num.polynomial_coefficients(x), ref_num.polynomial_coefficients(x)),
    ):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [3, 6, 10, 13])
@pytest.mark.parametrize("family", ["lobatto", "radau"])
def test_discretization_blocks_match_reference(family, n):
    for name in ("_integration_block", "_translation_block"):
        np.testing.assert_allclose(
            getattr(port_disc, name)(family, n), getattr(ref_disc, name)(family, n),
            rtol=0, atol=ATOL,
        )
    mesh = np.array([0.0, 0.2, 0.45, 1.0])
    num_point = np.array([n, n + 1, n])
    d, d_r = (m.Discretization(family, mesh, num_point, 2, 1) for m in (port_disc, ref_disc))
    for name in ("t_x", "t_m", "w_m", "T_v", "I_m", "V_x_aug", "T_x_aug_v", "I_m_aug", "l_v", "r_v"):
        np.testing.assert_allclose(getattr(d, name), getattr(d_r, name), rtol=0, atol=ATOL)


def _bang_bang_phase(disc_mod):
    """A one-control phase stand-in on 5 LGL intervals with a switch at
    t = 0.37 and a smooth ramp across the border at 0.8."""
    mesh = np.linspace(0.0, 1.0, 6)
    d = disc_mod.Discretization("lobatto", mesh, np.full(5, 8), 1, 1)
    f_bb = 1.0 / (1.0 + np.exp(-(d.t_m - 0.37) * 80.0)) - 0.6 * np.exp(-((d.t_m - 0.8) / 0.05) ** 2)
    phase = SimpleNamespace(_mesh=mesh, N=5, n_b=1, l_m=d.l_m, r_m=d.r_m, d=d)
    return phase, np.clip(f_bb, 0.0, 1.0)[None, :]


def test_refine_discontinuous_mesh_matches_reference():
    args = (1e-3, 6, 12, 1e-3, 0.5)
    mesh, num_point = port_refine.refine_discontinuous_mesh(*_bang_bang_phase(port_disc), *args)
    mesh_r, num_point_r = ref_refine.refine_discontinuous_mesh(*_bang_bang_phase(ref_disc), *args)
    assert len(mesh) > 6  # the planner placed new borders
    np.testing.assert_allclose(mesh, mesh_r, rtol=0, atol=ATOL)
    assert list(num_point) == list(num_point_r)


class _StopAtDevice(torch.overrides.TorchFunctionMode):
    """Record the ``device`` of the first tensor made from host data, then
    stop the call: shows where an entry point would put its tensors
    without needing a card."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.as_tensor and "device" in kwargs:
            self.devices.append(str(kwargs["device"]))
            raise LookupError("stopped at the first placement")
        return func(*args, **kwargs)


@pytest.mark.parametrize("entry", ["solve", "solve_batch", "solve_batch_drained",
                                   "default_runtime", "inputs_from_numpy", "objective",
                                   "gradient", "constraints", "jacobian", "hessian",
                                   "nlp_callbacks", "error_stats", "solve_refine_batch",
                                   "ipopt_solve", "scipy_solve", "homotopy_sweep",
                                   "export_batch_solver"])
def test_entry_points_default_to_the_card(entry):
    system, phase = build_lqr(port_lobatto, 4, 5)
    guess = [port_lobatto.constant_guess(phase, 0), [0.0]]
    c = system.compiled
    z0 = np.zeros((3, c.L))
    call = {
        "solve": lambda: ipm.solve(system, guess),
        "solve_batch": lambda: ipm.solve_batch(system, z0),
        "solve_batch_drained": lambda: ipm.solve_batch_drained(system, z0),
        "default_runtime": lambda: c.default_runtime(),
        "inputs_from_numpy": lambda: interop.inputs_from_numpy(z0),
        "objective": lambda: c.objective(z0[0]),
        "gradient": lambda: c.gradient(z0[0]),
        "constraints": lambda: c.constraints(z0[0]),
        "jacobian": lambda: c.jacobian(z0[0]),
        "hessian": lambda: c.hessian(z0[0], np.zeros(c.m), 1.0),
        "nlp_callbacks": lambda: system.hessian(z0[0], np.zeros(c.m), 1.0),
        "error_stats": lambda: make_error_stats(system)(
            z0, (np.tile(c.phases[0].fixed_vals, (3, 1)),), (1e-8, 1e-8, 1e-3)),
        "solve_refine_batch": lambda: solve_refine_batch(system, guess),
        "ipopt_solve": lambda: ipopt.solve(system, guess, {"tol": 1e-8}),
        "scipy_solve": lambda: scipy.solve(system, guess),
        "homotopy_sweep": lambda: homotopy_sweep(
            system, z0, [(np.tile(c.phases[0].fixed_vals, (3, 1)),)]),
        "export_batch_solver": lambda: aot.export_batch_solver(system, 3),
    }[entry]
    watch = _StopAtDevice()
    with watch, pytest.raises(LookupError):
        call()
    assert watch.devices == ["cuda"]
    if not torch.cuda.is_available():
        # no card: asking for one raises PyTorch's own error, no fallback
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_instance_mesh_defaults_to_the_card(monkeypatch):
    """With no process group, ``instance_mesh()`` makes its one-rank group on
    the card (NCCL), on the card the process has chosen (it sets none);
    with no card it raises before making any group."""
    import torch.distributed as dist

    import pockit_tpu_torch.parallel.distributed as port_dist

    asked = []

    def init_process_group(backend, **kw):
        asked.append(backend)
        raise LookupError("stopped at the group")

    monkeypatch.setattr(port_dist.torch.cuda, "init", lambda: asked.append("init"))
    monkeypatch.setattr(port_dist.torch.cuda, "set_device", lambda d: asked.append(("set_device", d)))
    monkeypatch.setattr(port_dist.dist, "init_process_group", init_process_group)
    with pytest.raises(LookupError):
        instance_mesh()
    assert asked == ["init", "nccl"] and not dist.is_initialized()
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            instance_mesh()
        assert not dist.is_initialized()
