"""The port's slice as a whole on the CPU: the README LQR through the
public entry points (``solve``, ``solve_batch``, ``solve_batch_drained``)
against the JAX package, lane by lane, with one options object describing
both runs.

On the CPU ``kkt_solver="pallas"`` runs the kernels' plain versions in
the port and the Pallas kernels in interpret mode in the reference.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.solver.ipm as port_ipm_solver
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.optimizer._common import preprocess as ref_preprocess
from pockit_tpu.solver import IPOptions as RefOptions
from pockit_tpu_torch import interop
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.solver import IPOptions

from test_torch_frontend import build_lqr

J1 = 0.2319139744522318  # LQR objective at x(0) = 1 (reference README)


def test_solve_float64_matches_reference():
    port_sys, phase = build_lqr(port_lobatto)
    [var_p, var_s], info = ipm.solve(
        port_sys, [port_lobatto.constant_guess(phase, 0), [0.0]], device="cpu", dtype=torch.float64
    )
    ref_sys, ref_phase = build_lqr(ref_lobatto)
    _, ref_info = ref_ipm.solve(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]])
    assert info["status"] == 0, info
    # the reference's own float64 gate (tests/test_end_to_end/test_lqr.py)
    assert abs(info["obj_val"] - J1) < 1e-8
    assert info["iterations"] == ref_info["iterations"]
    assert abs(var_p.x[0][0] - 1.0) < 1e-12
    assert var_p.x[0][-1] == pytest.approx(float(var_s[0]), abs=1e-9)


@functools.cache
def _systems():
    """The 6x6 LQR in both packages and the reference's initial guess,
    built once for the module. The reference compiles a batched solver per
    system, options and batch shape, and compiling dominates these tests'
    time, so tests that solve with the same options and batch size share
    one compile."""
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    port_sys, _ = build_lqr(port_lobatto, 6, 6)
    x0, _ = ref_preprocess(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]])
    return ref_sys, port_sys, x0


def _batch(B, seed):
    ref_sys, port_sys, x0 = _systems()
    bc = np.tile(ref_sys.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.random.default_rng(seed).uniform(0.5, 1.5, B)
    return ref_sys, port_sys, np.tile(x0, (B, 1)), bc


def test_solve_batch_matches_reference_lane_by_lane():
    """Every lane of this QP converges in 2 iterations, so ``max_iter=2``
    asks for nothing less; it makes the reference's solver the same
    program as the first pass of the drained test below."""
    ref_sys, port_sys, z0, bc = _batch(24, 5)
    ref_opts = RefOptions(kkt_solver="pallas", max_iter=2)
    opts = interop.options_from_reference(ref_opts)
    assert dataclasses.asdict(opts) == dataclasses.asdict(ref_opts)
    want = ref_ipm.solve_batch(ref_sys, z0, bc_overrides=(jnp.asarray(bc),), optimizer_options=ref_opts)
    z0_t, _, bc_t = interop.inputs_from_numpy(z0, None, (bc,), device="cpu", dtype=torch.float64)
    got = interop.result_to_numpy(
        ipm.solve_batch(port_sys, z0_t, bc_overrides=bc_t, optimizer_options=opts)
    )
    np.testing.assert_array_equal(got["status"], np.asarray(want.status))
    np.testing.assert_array_equal(got["iterations"], np.asarray(want.iterations))
    # float64 solves of the same problem: agreement to the tolerance's scale
    np.testing.assert_allclose(got["obj"], np.asarray(want.obj), rtol=1e-8)
    np.testing.assert_allclose(got["obj"], J1 * bc[:, 0] ** 2, rtol=1e-6)
    assert got["z"].shape == (24, port_sys.L)


@pytest.mark.parametrize(
    "first_pass_iters, drain_frac", [(2, 8), (1, 4)], ids=["drained", "forced_rounds"]
)
def test_solve_batch_drained_matches_reference(first_pass_iters, drain_frac):
    """``first_pass_iters=1`` leaves every lane unconverged, so the drain
    rounds (B_drain = 8 < 12 pending: two rounds, the last tiled with
    repeated indices) produce the whole result."""
    B = 24 if first_pass_iters == 2 else 12
    ref_sys, port_sys, z0, bc = _batch(B, 11)
    opts = IPOptions(kkt_solver="pallas")
    kw = dict(first_pass_iters=first_pass_iters, drain_frac=drain_frac,
              max_drain_rounds=4, return_first_pass_mask=True)
    want = ref_ipm.solve_batch_drained(
        ref_sys, z0, bc_overrides=(bc,), optimizer_options=RefOptions(kkt_solver="pallas"), **kw
    )
    got = ipm.solve_batch_drained(
        port_sys, z0, bc_overrides=(bc,), optimizer_options=opts, device="cpu", dtype=torch.float64,
        **kw
    )
    status, obj, iters, z, mask1 = got
    np.testing.assert_array_equal(mask1, want[4])
    assert mask1.any() == (first_pass_iters == 2)
    np.testing.assert_array_equal(status, want[0])
    assert (status == 0).all()
    np.testing.assert_array_equal(iters, want[2])
    np.testing.assert_allclose(obj, want[1], rtol=1e-8)
    np.testing.assert_allclose(obj, J1 * bc[:, 0] ** 2, rtol=1e-6)
    assert z.shape == (B, port_sys.L) and torch.isfinite(z).all()


_F32_REF = """
import jax
jax.config.update("jax_platforms", "cpu")
import json, sys
sys.path.insert(0, {tests!r})
import pockit_tpu.lobatto as lobatto
from pockit_tpu.optimizer import ipm
from test_torch_frontend import build_lqr
assert not jax.config.jax_enable_x64
system, phase = build_lqr(lobatto, {mesh}, {mesh})
_, info = ipm.solve(system, [lobatto.constant_guess(phase, 0), [0.0]])
print(json.dumps([info["status"], info["obj_val"], info["iterations"]]))
"""


@pytest.mark.parametrize("mesh", [4, 6])
def test_solve_float32_matches_reference(mesh):
    """Float32 single solves on the block path with the default options
    (the reference's Newton residual acceptance, rtol 1e-2) take the
    reference's iteration count. The reference runs in a subprocess with
    x64 off, as its own float32 gates do. The 10x10 mesh is left out on
    purpose: there the rule sits at the float32 rounding floor of K, and
    which solves pass it depends on summation order (PERF.md Findings)."""
    import json
    import os
    import subprocess
    import sys

    script = _F32_REF.format(tests=os.path.dirname(__file__), mesh=mesh)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_status, ref_obj, ref_iters = json.loads(proc.stdout.strip().splitlines()[-1])
    system, phase = build_lqr(port_lobatto, mesh, mesh)
    _, info = ipm.solve(
        system, [port_lobatto.constant_guess(phase, 0), [0.0]], device="cpu",
        dtype=torch.float32,
    )
    assert ref_status == info["status"] == 0
    assert info["iterations"] == ref_iters
    # both float32: the gate's own tolerance
    assert info["obj_val"] == pytest.approx(ref_obj, abs=5e-6)


@pytest.mark.parametrize("kkt_solver", ["auto", "pallas"])
def test_float32_lqr_gate(kkt_solver):
    """The reference's float32 gate (tests/test_end_to_end/
    test_float32_gates.py): float32 parity against the float64 objective
    (abs 5e-6) within 12 iterations; "auto" takes the plain block core
    on the CPU, "pallas" the kernels' plain versions. With the options of
    the float32 bench cell: ``newton_residual_rtol=0``, because at 10x10
    the residual of any float32 solve of this K is near or above
    1e-2 * ||rhs|| (1/delta_c = 8.4e4 entries), so the default rule
    escalates sound steps in both packages."""
    system, phase = build_lqr(port_lobatto)
    opts = dataclasses.replace(
        ipm.default_options(torch.float32), kkt_solver=kkt_solver, newton_residual_rtol=0.0
    )
    _, info = ipm.solve(
        system, [port_lobatto.constant_guess(phase, 0), [0.0]], opts, device="cpu",
        dtype=torch.float32,
    )
    assert info["status"] == 0
    assert info["obj_val"] == pytest.approx(J1, abs=5e-6)
    assert info["iterations"] <= 12


def test_solve_turns_tf32_off_and_restores_the_callers_flags():
    """The GPU twin of the reference's bf16 trap: with the solver's default
    ``matmul_precision="highest"`` no float32 matmul inside a solve may
    run in TF32, whatever the caller set; the caller's flags come back
    afterwards."""
    seen = []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.einsum, torch.matmul, torch.Tensor.__matmul__):
                seen.append(
                    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
                )
            return func(*args, **(kwargs or {}))

    system, phase = build_lqr(port_lobatto, 4, 5)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with Watch():
            _, info = ipm.solve(
                system, [port_lobatto.constant_guess(phase, 0), [0.0]], device="cpu",
                dtype=torch.float32,
            )
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert info["status"] == 0
    assert seen, "no matmul was observed inside the solve"
    assert set(seen) == {(False, False)}
    assert after == (True, True)


# the options of each case
_CASES = {
    "adaptive": dict(mu_strategy="adaptive"),
    "unrolled": dict(block_core="unrolled", kkt_solver="block"),
    "live_metrics": dict(live_metrics=True),
}
# the module constants the developer variables set (read at import)
_HOOK_CONSTANTS = {"POCKIT_DUMP_KKT": "_DUMP_KKT", "POCKIT_IPM_DEBUG_TRACE": "_DEBUG_TRACE"}


@pytest.mark.parametrize("name", sorted(_CASES) + sorted(_HOOK_CONSTANTS))
def test_unported_options_raise(name, monkeypatch, tmp_path):
    """Every option that raised here until it was ported solves: the LOQO
    barrier rule, the unrolled block core, and the ops hooks
    (``live_metrics`` and the two developer variables). Their results are
    held against the reference by ``tests/test_torch_fuzz.py``,
    ``tests/test_torch_unrolled.py`` and ``tests/test_torch_ops.py``."""
    system, phase = build_lqr(port_lobatto, 4, 5)
    opts = IPOptions(**_CASES.get(name, {}))
    if name in _HOOK_CONSTANTS:
        value = str(tmp_path / "kkt.npz") if name == "POCKIT_DUMP_KKT" else True
        monkeypatch.setattr(port_ipm_solver, _HOOK_CONSTANTS[name], value)
    _, info = ipm.solve(system, [port_lobatto.constant_guess(phase, 0), [0.0]], opts,
                        device="cpu", dtype=torch.float64)
    assert info["status"] == 0
    if name == "unrolled":
        assert info["kkt_solver"] == "block"


@pytest.mark.parametrize("kkt_solver", ["block", "pallas"])
def test_mehrotra_runs_and_matches_reference(kkt_solver):
    """``mu_strategy="mehrotra"`` is ported: on the 4x5 LQR, on both KKT
    paths, the port takes the reference's iterations to the same float64
    objective (within 1e-8)."""
    ref_sys, ref_phase = build_lqr(ref_lobatto, 4, 5)
    _, want = ref_ipm.solve(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]],
                            RefOptions(mu_strategy="mehrotra", kkt_solver=kkt_solver))
    system, phase = build_lqr(port_lobatto, 4, 5)
    _, info = ipm.solve(system, [port_lobatto.constant_guess(phase, 0), [0.0]],
                        IPOptions(mu_strategy="mehrotra", kkt_solver=kkt_solver), device="cpu",
                        dtype=torch.float64)
    assert info["status"] == want["status"] == 0
    assert info["iterations"] == want["iterations"]
    assert abs(info["obj_val"] - want["obj_val"]) <= 1e-8


def test_interop_rejects_unknown_option_fields():
    with pytest.raises(ValueError, match="unknown IPOptions fields"):
        interop.options_from_reference({"tol": 1e-8, "print_level": 0})
    assert interop.options_from_reference({"tol": 1e-6}) == IPOptions(tol=1e-6)


def test_preprocess_matches_reference():
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    port_sys, port_phase = build_lqr(port_lobatto, 6, 6)
    x_ref, single_ref = ref_preprocess(ref_sys, [ref_lobatto.linear_guess(ref_phase, 0.5), [0.3]])
    x, single = preprocess(port_sys, [port_lobatto.linear_guess(port_phase, 0.5), [0.3]])
    np.testing.assert_array_equal(x, x_ref)
    assert single == single_ref
