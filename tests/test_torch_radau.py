"""The port's Radau slice against the JAX package on the CPU, in float64
unless a test says otherwise: the Radau ``Variable`` layouts and guesses,
the NLP functions, derivatives and block assembly of the orbit transfer at
4x5 Radau, the bang-bang solve -> refine -> solve loop, Mehrotra probing,
and the batched error statistics (the float32 gates are in
``test_torch_float32_gates.py``).

The same inputs, made from a seed with numpy, go to both packages. The
reference's solves are shared between tests with module fixtures.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu.radau as ref_radau
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.radau as port_radau
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.optimizer._common import preprocess as ref_preprocess
from pockit_tpu.solver import IPOptions as RefOptions
from pockit_tpu.transcription.error import make_error_stats as ref_error_stats
from pockit_tpu.transcription.kkt import make_block_kkt as ref_block_kkt
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.transcription.error import make_error_stats
from pockit_tpu_torch.transcription.kkt import make_block_kkt

from chip_smoke import build_orbit

RTOL = 1e-10  # the same float64 arithmetic, summed in another order by another library
CPU64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


def build_bang_bang(radau, mesh=5, num_point=7, t_bounds=False):
    """Minimum-time double integrator (tests/test_end_to_end/
    test_bang_bang.py); with ``t_bounds`` the Mehrotra test's variant
    (tests/test_solver/test_mehrotra.py: 3x6, a path bound on t)."""
    system = radau.System(0)
    phase = system.new_phase(["x", "v"], ["u"])
    x, v = phase.x
    (u,) = phase.u
    phase.set_dynamics([v, u])
    phase.set_integral([1])
    if t_bounds:
        phase.set_phase_constraint([u, phase.t], [-1.0, 0.5], [1.0, 6.0],
                                   bang_bang_control=[True, False])
    else:
        phase.set_phase_constraint([u], [-1.0], [1.0], bang_bang_control=True)
    phase.set_boundary_condition([0.0, 0.0], [1.0, 0.0], 0.0, None)
    phase.set_discretization(mesh, num_point)
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    guess = radau.linear_guess(phase, 0.5)
    guess.t_f = 3.0
    return system, phase, guess


# ---------------------------------------------------------------------------
# (a) layouts and guesses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "linear"])
def test_radau_variable_layouts_and_guesses_match_reference(kind):
    """States take num_point + 1 points per interval with shared borders,
    controls num_point per interval, block-diagonal; the guesses, the
    accessors and the interpolation matrices equal the reference's (the
    node positions to 1e-13: the reference may take its native C++ path
    for the nodes, ``tests/test_torch_standalone.py``)."""
    systems = [build_orbit(m, 4, 5)[0] for m in (ref_radau, port_radau)]
    ref_phase, port_phase = (s.p[0] for s in systems)
    fill = 0.7
    ref_v = getattr(ref_radau, f"{kind}_guess")(ref_phase, fill)
    v = getattr(port_radau, f"{kind}_guess")(port_phase, fill)
    assert type(v).__module__ == "pockit_tpu_torch.radau"
    np.testing.assert_array_equal(v.data, ref_v.data)
    assert len(v.x) == 3 and len(v.u) == 1
    assert len(v.x[0]) == 4 * (5 + 1) - 3 and len(v.u[0]) == 4 * 5
    for i in range(3):
        np.testing.assert_array_equal(v.x[i], ref_v.x[i])
    np.testing.assert_array_equal(v.u[0], ref_v.u[0])
    np.testing.assert_allclose(v.t_x, ref_v.t_x, rtol=0, atol=1e-13)
    np.testing.assert_allclose(v.t_u, ref_v.t_u, rtol=0, atol=1e-13)
    t = np.linspace(v.t_0, v.t_f, 23)
    for name in ("V_x", "V_u", "D_x", "D_u"):
        np.testing.assert_allclose(getattr(v, name)(t), getattr(ref_v, name)(t), rtol=0, atol=1e-13)


def test_gate_guess_packs_like_reference():
    """The orbit gate's guess (states, control and static) flattens to the
    same NLP vector in both packages (to 1e-13: r's guess follows the node
    positions)."""
    x_ref, _ = ref_preprocess(*build_orbit(ref_radau, 4, 5))
    x, _ = preprocess(*build_orbit(port_radau, 4, 5))
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# (b) NLP functions, derivatives and block assembly at 4x5 Radau
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def orbit_pair():
    return build_orbit(ref_radau, 4, 5)[0], build_orbit(port_radau, 4, 5)[0]


def _point(system, seed):
    """A random point near the gate's guess (the dynamics divide by r), with
    multipliers, a positive diagonal and FIXED values off the configured
    ones."""
    rng = np.random.default_rng(seed)
    c = system.compiled
    z = preprocess(*build_orbit(port_radau, 4, 5))[0] + rng.uniform(-0.05, 0.05, c.L)
    y = rng.standard_normal(c.m)
    D = rng.uniform(0.5, 2.0, c.m)
    bc = tuple(cp.fixed_vals + rng.uniform(-0.02, 0.02, len(cp.fixed_vals)) for cp in c.phases)
    return z, y, D, bc


def test_nlp_functions_and_derivatives_match_reference(orbit_pair):
    ref_sys, port_sys = orbit_pair
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


def test_block_assembly_matches_reference(orbit_pair):
    ref_sys, port_sys = orbit_pair
    z, y, D, bc = _point(ref_sys, 1)
    ref_blk, blk = ref_block_kkt(ref_sys), make_block_kkt(port_sys)
    np.testing.assert_array_equal(blk.interior_pad, np.asarray(ref_blk.interior_pad))
    np.testing.assert_array_equal(blk.layout.reduced, np.asarray(ref_blk.layout.reduced))
    assert blk.interior_pad.shape == (4, 17) and len(blk.layout.reduced) == 18
    want = ref_blk.assemble(jnp.asarray(z), jnp.asarray(y), jnp.asarray(D),
                            {"bc": tuple(jnp.asarray(b) for b in bc)})
    t = torch.as_tensor
    got = blk.assemble(t(z), t(y), t(D), {"bc": tuple(t(b) for b in bc)})
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# (c) bang-bang: solve -> refine -> solve through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bang_bang_ref():
    """The reference's solve, refine and re-solve, once for the module."""
    system, phase, guess = build_bang_bang(ref_radau)
    var, info1 = ref_ipm.solve(system, guess)
    ok_disc = phase.check_discontinuous(var)
    var = system.refine(var)
    mesh, num_point = np.array(phase._mesh), np.array(phase._num_point)
    var, info2 = ref_ipm.solve(system, var)
    return info1, ok_disc, mesh, num_point, info2, var


def test_bang_bang_solve_refine_solve_matches_reference(bang_bang_ref):
    info1_r, ok_disc_r, mesh_r, num_point_r, info2_r, var_r = bang_bang_ref
    system, phase, guess = build_bang_bang(port_radau)
    var, info1 = ipm.solve(system, guess, **CPU64)
    assert info1["status"] == info1_r["status"] == 0
    assert info1["iterations"] == info1_r["iterations"]
    assert abs(info1["obj_val"] - info1_r["obj_val"]) <= 1e-8
    # the switch at t = 1 falls inside an interval: both checks fail
    assert not ok_disc_r and not phase.check_discontinuous(var)
    var = system.refine(var)
    np.testing.assert_allclose(phase._mesh, mesh_r, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(phase._num_point, num_point_r)
    assert np.min(np.abs(phase._mesh - 0.5)) < 2e-2  # a border at the switch
    var, info2 = ipm.solve(system, var, **CPU64)
    assert info2["status"] == info2_r["status"] == 0
    assert abs(info2["obj_val"] - info2_r["obj_val"]) <= 1e-8
    assert info2["obj_val"] == pytest.approx(2.0, abs=2e-4)
    np.testing.assert_allclose(var.data, var_r.data, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) Mehrotra probing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mehrotra_ref():
    system, _, guess = build_bang_bang(ref_radau, 3, 6, t_bounds=True)
    out = {}
    for kkt in ("block", "pallas"):
        _, info = ref_ipm.solve(system, guess, RefOptions(tol=1e-8, mu_strategy="mehrotra",
                                                          kkt_solver=kkt))
        out[kkt] = info
    return out


@pytest.mark.parametrize("kkt_solver", ["block", "pallas"])
def test_mehrotra_matches_reference(mehrotra_ref, kkt_solver):
    """On the Mehrotra test's bang-bang problem (tests/test_solver/
    test_mehrotra.py), on both KKT paths ("pallas": the kernels' plain
    versions here, the Pallas kernels in interpret mode in the reference):
    the same status and iterations, the objective within 1e-8; and no
    more iterations than the monotone ladder, as the reference's test
    asks."""
    want = mehrotra_ref[kkt_solver]
    system, _, guess = build_bang_bang(port_radau, 3, 6, t_bounds=True)
    opts = IPOptions(tol=1e-8, mu_strategy="mehrotra", kkt_solver=kkt_solver)
    _, info = ipm.solve(system, guess, opts, **CPU64)
    assert info["status"] == want["status"] == 0
    assert info["iterations"] == want["iterations"]
    assert abs(info["obj_val"] - want["obj_val"]) <= 1e-8
    assert abs(info["obj_val"] - 2.0) < 5e-3
    _, mono = ipm.solve(system, guess, dataclasses.replace(opts, mu_strategy="monotone"), **CPU64)
    assert mono["status"] == 0 and info["iterations"] <= mono["iterations"]


def test_mehrotra_batched_matches_single():
    """Batch-first with per-lane masks: four lanes of the same problem
    (the reference's ``test_mehrotra_batched_matches_single``) converge to
    the single solve's objective."""
    system, _, guess = build_bang_bang(port_radau, 3, 6, t_bounds=True)
    opts = IPOptions(tol=1e-8, mu_strategy="mehrotra")
    _, info = ipm.solve(system, guess, opts, **CPU64)
    res = ipm.solve_batch(system, np.tile(guess.data, (4, 1)), optimizer_options=opts, **CPU64)
    assert (res.status == 0).all()
    np.testing.assert_allclose(res.obj.numpy(), info["obj_val"], rtol=0, atol=1e-9)
    assert (res.iterations == info["iterations"]).all()


# ---------------------------------------------------------------------------
# (f) batched error statistics
# ---------------------------------------------------------------------------


def _error_stats_system(mod):
    """tests/test_transcription/test_error_stats.py's double integrator
    (Radau, a bang-bang control, ragged degrees)."""
    system = mod.System(0)
    phase = system.new_phase(["x", "v"], ["u"])
    x, v = phase.x
    (u,) = phase.u
    phase.set_dynamics([v, u])
    phase.set_integral([1])
    phase.set_phase_constraint([u, phase.t], [-1.0, 0.5], [1.0, 6.0],
                               bang_bang_control=[True, False])
    phase.set_boundary_condition([0.0, 0.0], [1.0, 0.0], 0.0, None)
    phase.set_discretization([0, 0.45, 0.8, 1.0], [5, 6, 4])
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    return system


@pytest.mark.parametrize("family", ["radau", "lobatto"])
def test_error_stats_match_reference(family):
    """``cont_ok``, ``ratio`` (rtol 1e-12) and ``disc_sat`` of random
    iterates with per-lane FIXED overrides and a NaN lane, on the device of
    the inputs (here the CPU), two tolerance triples through one built
    function."""
    if family == "radau":
        ref_sys, port_sys = (_error_stats_system(m) for m in (ref_radau, port_radau))
    else:
        ref_sys, port_sys = (build_orbit(m, 3, 5)[0] for m in (ref_lobatto, port_lobatto))
    B = 7
    rng = np.random.default_rng(42)
    z = rng.normal(size=(B, ref_sys.L))
    z[:, ref_sys.r_p[0] - 2] = 0.0
    z[:, ref_sys.r_p[0] - 1] = rng.uniform(1.5, 3.0, B)
    if family == "lobatto":
        # the orbit divides by r and takes sqrt(r_f): keep both near 1
        z[:, : ref_sys.r_p[0] - 2] = 1.0 + 0.1 * z[:, : ref_sys.r_p[0] - 2]
        z[:, -1] = 1.5
    z[3, 5] = np.nan
    bc = np.tile(ref_sys.compiled.phases[0].fixed_vals, (B, 1))
    bc += rng.normal(scale=0.1, size=bc.shape)
    ref_fn, fn = ref_error_stats(ref_sys), make_error_stats(port_sys)
    for tols in ((1e-5, 1e-4, 1e-3), (1e-1, 1e-1, 1e-1)):
        want = ref_fn(z, (bc,), tols)
        got = fn(torch.as_tensor(z), (torch.as_tensor(bc),), tols)
        for (cont_ok, ratio, disc_sat), (c_r, r_r, d_r) in zip(got, want):
            assert cont_ok.device.type == "cpu" and cont_ok.shape == (B, port_sys.p[0].N)
            np.testing.assert_array_equal(cont_ok.numpy(), np.asarray(c_r))
            np.testing.assert_array_equal(disc_sat.numpy(), np.asarray(d_r))
            np.testing.assert_allclose(ratio.numpy(), np.asarray(r_r), rtol=1e-12, atol=0)
            assert np.isnan(ratio.numpy()[3]).any()
