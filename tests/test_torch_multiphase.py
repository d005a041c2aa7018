"""The port's linked multi-phase slice against the JAX package on the CPU:
the 3-phase Goddard rocket (three 4x7 Radau phases linked through FUNC
boundary conditions on nine statics, equal-bound controls pinned in phases
1 and 3, the drag's 310 exp(-500 (h - 1))) through the NLP functions,
derivatives, block assembly and a float64 solve; and checkpoints written
by one package and read by the other.

The same inputs, made from a seed with numpy, go to both packages. The
reference's Goddard solve is shared between tests with a module fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pockit_tpu.radau as ref_radau
import pockit_tpu_torch.radau as port_radau
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.transcription.kkt import make_block_kkt as ref_block_kkt
from pockit_tpu.utils import load_solution as ref_load
from pockit_tpu.utils import save_solution as ref_save
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.transcription.kkt import make_block_kkt
from pockit_tpu_torch.utils import load_solution, save_solution

from chip_smoke import H_STAR, U_MAX, build_goddard

RTOL = 1e-10  # the same float64 arithmetic, summed in another order by another library
CPU64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def goddard_pair():
    return build_goddard(ref_radau)[0], build_goddard(port_radau)[0]


def _point(system, seed):
    """A random point near the guess (the dynamics divide by m and h), with
    multipliers, a positive diagonal and FIXED values, the pinned controls'
    included, off the configured ones."""
    rng = np.random.default_rng(seed)
    c = system.compiled
    z = preprocess(*build_goddard(port_radau))[0] * rng.uniform(0.97, 1.03, c.L)
    y = rng.standard_normal(c.m)
    D = rng.uniform(0.5, 2.0, c.m)
    bc = tuple(cp.fixed_vals * rng.uniform(0.97, 1.03, len(cp.fixed_vals)) for cp in c.phases)
    return z, y, D, bc


def test_goddard_layout_matches_reference(goddard_pair):
    """Three phases of 4 intervals: 12 interior blocks of 25, a reduced
    block of 60 (borders, phase times and the nine statics), pinned
    controls appended to each phase's FIXED slots after the boundary
    conditions."""
    ref_sys, port_sys = goddard_pair
    for cp, cp_r in zip(port_sys.compiled.phases, ref_sys.compiled.phases):
        np.testing.assert_array_equal(cp.fixed_idx, np.asarray(cp_r.fixed_idx))
        np.testing.assert_array_equal(cp.fixed_vals, np.asarray(cp_r.fixed_vals))
    p1 = port_sys.compiled.phases[0]
    assert list(p1.fixed_vals[:4]) == [1.0, 0.0, 1.0, 0.0] and (p1.fixed_vals[4:] == U_MAX).all()
    blk, ref_blk = make_block_kkt(port_sys), ref_block_kkt(ref_sys)
    np.testing.assert_array_equal(blk.interior_pad, np.asarray(ref_blk.interior_pad))
    np.testing.assert_array_equal(blk.layout.reduced, np.asarray(ref_blk.layout.reduced))
    assert blk.interior_pad.shape == (12, 25) and len(blk.layout.reduced) == 60


def test_nlp_functions_and_derivatives_match_reference(goddard_pair):
    ref_sys, port_sys = goddard_pair
    rc, pc = ref_sys.compiled, port_sys.compiled
    z, y, _, bc = _point(ref_sys, 0)
    rt_ref = {"bc": tuple(jnp.asarray(b) for b in bc)}
    rt = {"bc": tuple(torch.as_tensor(b) for b in bc)}
    cpu = dict(device="cpu")
    _close(pc.objective(z, rt, **cpu), rc.objective(z, rt_ref))
    _close(pc.gradient(z, rt, **cpu), rc.gradient(z, rt_ref))
    _close(pc.constraints(z, rt, **cpu), rc.constraints(z, rt_ref))
    _close(pc.jacobian(z, rt, **cpu), rc.jacobian(z, rt_ref))
    _close(pc.hessian(z, y, 0.7, rt, **cpu), rc.hessian(z, y, 0.7, rt_ref))


def test_block_assembly_matches_reference(goddard_pair):
    """Ragged blocks across phases: the interval blocks of all three
    phases, coupled through the shared statics in the reduced block."""
    ref_sys, port_sys = goddard_pair
    z, y, D, bc = _point(ref_sys, 1)
    want = ref_block_kkt(ref_sys).assemble(
        jnp.asarray(z), jnp.asarray(y), jnp.asarray(D), {"bc": tuple(jnp.asarray(b) for b in bc)}
    )
    t = torch.as_tensor
    got = make_block_kkt(port_sys).assemble(t(z), t(y), t(D), {"bc": tuple(t(b) for b in bc)})
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_exp_coefficient_fold_keeps_float32_finite(goddard_pair):
    """SymPy splits 310 exp(-500 (h - 1)) into 4.35e219 exp(-500 h), which
    is inf in float32; the fold keeps the float32 constraints finite and
    equal to the float64 ones to 1e-4 of their largest entry (each row is
    a difference of float32 sums of larger terms)."""
    _, port_sys = goddard_pair
    z, _, _, bc = _point(port_sys, 2)
    c = port_sys.compiled
    c64 = c.constraints_fn(torch.as_tensor(z), {"bc": tuple(torch.as_tensor(b) for b in bc)})
    c32 = c.constraints_fn(torch.as_tensor(z, dtype=torch.float32),
                           {"bc": tuple(torch.as_tensor(b, dtype=torch.float32) for b in bc)})
    assert torch.isfinite(c32).all()
    _close(c32.numpy(), c64.numpy(), rtol=1e-4)


@pytest.fixture(scope="module")
def goddard_ref():
    """The reference's float64 solve, once for the module."""
    system, guess = build_goddard(ref_radau)
    result, info = ref_ipm.solve(system, guess)
    return result, info


@pytest.fixture(scope="module")
def goddard_port():
    system, guess = build_goddard(port_radau)
    result, info = ipm.solve(system, guess, **CPU64)
    return system, result, info


def test_goddard_solve_matches_reference(goddard_ref, goddard_port):
    """Float64, default options, the block path: the same status and
    iterations; h_f within 1e-8 of the reference's; the pinned controls
    back at their pins within 1e-6; every static within 1e-6 of the
    reference's; ordered phase times."""
    result_r, info_r = goddard_ref
    _, result, info = goddard_port
    assert info["status"] == info_r["status"] == 0
    assert info["iterations"] == info_r["iterations"]
    statics = result[-1]
    assert abs(float(statics[-1]) - float(result_r[-1][-1])) <= 1e-8
    assert float(statics[-1]) == pytest.approx(H_STAR, abs=5e-4)
    assert np.max(np.abs(result[0].u[0] - U_MAX)) < 1e-6
    assert np.max(np.abs(result[2].u[0])) < 1e-6
    assert 0 < statics[0] < statics[1] < statics[2]
    np.testing.assert_allclose(statics, result_r[-1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_between_packages(goddard_ref, goddard_port, writer, tmp_path):
    """A 3-phase checkpoint written by one package is read by the other,
    data, meshes and statics unchanged; the port warm-starts from the
    reference's and re-converges to its own h_f in no more iterations than
    its cold solve."""
    result_r, _ = goddard_ref
    system, result, info = goddard_port
    ref_system, _ = build_goddard(ref_radau)
    path = str(tmp_path / "goddard.npz")
    if writer == "port":
        save_solution(path, system, result)
        value = ref_load(path, ref_system)
        source = result
    else:
        ref_save(path, ref_system, result_r)
        value = load_solution(path, system)
        source = result_r
        assert type(value[0]).__module__ == "pockit_tpu_torch.radau"
    for v_new, v_old in zip(value[:3], source[:3]):
        np.testing.assert_array_equal(v_new.data, v_old.data)
        np.testing.assert_array_equal(v_new._mesh, v_old._mesh)
    np.testing.assert_array_equal(value[-1], np.asarray(source[-1], dtype=np.float64))
    if writer == "reference":
        result2, info2 = ipm.solve(system, value, **CPU64)
        assert info2["status"] == 0
        assert info2["iterations"] <= info["iterations"]
        assert float(result2[-1][-1]) == pytest.approx(float(result[-1][-1]), abs=1e-7)
