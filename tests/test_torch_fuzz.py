"""The JAX package's randomized OCP families through both packages, and the
LOQO barrier rule (``mu_strategy="adaptive"``) on the 4x5 LQR.

The two families of ``tests/test_solver/test_fuzz.py`` are copied here (not
imported from that module) and built through each package's ``lobatto`` or
``radau``, as the seed picks: ``_random_ocp`` (random stable linear
dynamics, quadratic cost, fixed or free terminal states, half of them with
a control box), solved with the barrier rule the JAX test rotates by seed,
and ``_random_head_ocp`` (a static parameter, a FUNC boundary condition, a
system constraint on an integral, an objective nonlinear in the integrals)
on the block path. Float64 on the CPU. Gates: equal status, equal
iteration count, objective within 1e-9 relative.

Seed 7 (adaptive) is decided by rounding: the rule takes mu to tol/10 at
iteration 0, where the condensed matrix carries 1/delta_c ~ 1e8 on its
equality rows, and the first step then moves by ~1e-6 relative between
any two factorizations of it; the JAX package's own block and dense paths
take 12 and 7 iterations there. Its gate is equal status, the objective
within 1e-9 relative, and an iteration count within the JAX package's own
two counts, which the test shows to differ.

The adaptive seeds (1, 4, 7, 10) and two head seeds run in tier-1; the
other cases are marked ``slow`` (each is one more JAX solver compile).
Of the adaptive seeds only seed 7 has a bounded entry (a control box), and
the rule keeps mu on a problem with none, as on the LQR; so the bang-bang
double integrator of ``tools/compare_mu.py`` (control and time bounds,
where the rule moves mu every iteration) holds the rule itself, with its
mu per iteration, in tier-1.
"""

import functools

import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu.radau as ref_radau
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.radau as port_radau
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.solver import IPOptions as RefOptions
from pockit_tpu.solver.structured import structured_layout as ref_layout
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.solver.structured import structured_layout

from test_torch_frontend import build_lqr

RTOL = 1e-9
STRATEGIES = ["monotone", "adaptive", "mehrotra"]  # the JAX test's rotation by seed

_REF = (ref_lobatto, ref_radau)
_PORT = (port_lobatto, port_radau)


def _random_ocp(seed, mods):
    """``test_fuzz._random_ocp`` with the scheme taken from ``mods``
    (``(lobatto, radau)`` of one package)."""
    rng = np.random.default_rng(seed)
    mod = mods[0] if rng.random() < 0.5 else mods[1]
    n_x = int(rng.integers(1, 3))
    n_u = int(rng.integers(1, 3))
    system = mod.System(0)
    phase = system.new_phase(n_x, n_u)
    xs, us = phase.x, phase.u

    A = rng.normal(0, 1, (n_x, n_x)) - 1.5 * np.eye(n_x)
    Bm = rng.normal(0, 1, (n_x, n_u))
    dyn = []
    for i in range(n_x):
        expr = sum(A[i, j] * xs[j] for j in range(n_x)) + sum(
            Bm[i, j] * us[j] for j in range(n_u)
        )
        dyn.append(expr)
    phase.set_dynamics(dyn)
    phase.set_integral([sum(x_**2 for x_ in xs) + 0.1 * sum(u_**2 for u_ in us)])

    if rng.random() < 0.5:  # control box
        phase.set_phase_constraint(list(us), [-2.0] * n_u, [2.0] * n_u)

    bc0 = [float(rng.uniform(-1, 1)) for _ in range(n_x)]
    # reachable fixed terminal values: simulate with an admissible control
    u_star = rng.uniform(-1.0, 1.0, n_u)
    xv = np.array(bc0)
    h = 1.0 / 200
    for _ in range(200):
        f = lambda x_: A @ x_ + Bm @ u_star
        k1 = f(xv)
        k2 = f(xv + h / 2 * k1)
        k3 = f(xv + h / 2 * k2)
        k4 = f(xv + h * k3)
        xv = xv + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    bcf = [(float(xv[i]) if rng.random() < 0.5 else None) for i in range(n_x)]
    phase.set_boundary_condition(bc0, bcf, 0.0, 1.0)
    phase.set_discretization(int(rng.integers(2, 5)), int(rng.integers(4, 8)))
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    return mod, system, phase


def _random_head_ocp(seed, mods):
    """``test_fuzz._random_head_ocp`` with the scheme taken from ``mods``."""
    rng = np.random.default_rng(10_000 + seed)
    mod = mods[0] if rng.random() < 0.5 else mods[1]
    n_x = int(rng.integers(1, 3))
    system = mod.System(["a"])
    (a,) = system.s
    phase = system.new_phase(n_x, 1)
    xs, (u,) = phase.x, phase.u

    A = rng.normal(0, 1, (n_x, n_x)) - 1.5 * np.eye(n_x)
    Bm = rng.normal(0, 1, (n_x, 1))
    phase.set_dynamics(
        [sum(A[i, j] * xs[j] for j in range(n_x)) + Bm[i, 0] * u for i in range(n_x)]
    )
    phase.set_integral([sum(x_**2 for x_ in xs) + 0.1 * u**2, u**2])

    bc0 = [float(rng.uniform(-1, 1)) for _ in range(n_x)]
    bcf = [a] + [None] * (n_x - 1)
    phase.set_boundary_condition(bc0, bcf, 0.0, 1.0)
    phase.set_discretization(int(rng.integers(2, 4)), int(rng.integers(4, 7)))
    system.set_phase([phase])
    system.set_system_constraint([phase.I[1]], [0.0], [float(rng.uniform(0.5, 5.0))])

    if rng.random() < 0.5:
        system.set_objective(phase.I[0] + 0.2 * phase.I[0] ** 2 + a**2)
    else:
        system.set_objective(phase.I[0] + 0.3 * a * phase.I[1] + a**2)
    return mod, system, phase


def _solve_both(build, seed, guess_of, opts):
    """Solve family ``build``'s case ``seed`` in both packages with the same
    options; returns ``(reference info, port info, (reference system, port
    system))``."""
    ref_mod, ref_sys, ref_phase = build(seed, _REF)
    port_mod, port_sys, port_phase = build(seed, _PORT)
    assert ref_mod.__name__.rsplit(".", 1)[-1] == port_mod.__name__.rsplit(".", 1)[-1]
    _, want = ref_ipm.solve(ref_sys, guess_of(ref_mod, ref_phase), RefOptions(**opts))
    _, got = ipm.solve(port_sys, guess_of(port_mod, port_phase), IPOptions(**opts),
                       device="cpu", dtype=torch.float64)
    return want, got, (ref_sys, port_sys)


@functools.cache
def _ocp_case(seed):
    opts = dict(tol=1e-8, max_iter=200, mu_strategy=STRATEGIES[seed % 3])
    return _solve_both(_random_ocp, seed, lambda mod, ph: mod.constant_guess(ph, 0.1), opts)


@functools.cache
def _head_case(seed):
    opts = dict(tol=1e-8, max_iter=200, kkt_solver="block")
    return _solve_both(_random_head_ocp, seed,
                       lambda mod, ph: [mod.constant_guess(ph, 0.1), [0.0]], opts)


def _assert_same(want, got, iterations=True):
    assert got["status"] == want["status"] == 0, (want, got)
    if iterations:
        assert got["iterations"] == want["iterations"]
    assert abs(got["obj_val"] - want["obj_val"]) <= RTOL * max(abs(want["obj_val"]), 1e-300)


_TIER1_OCP = {1, 4, 7, 10}  # the adaptive seeds
_TIER1_HEAD = {1, 3}
_ROUNDING_DECIDED = {7}  # see the module docstring


@pytest.mark.parametrize("seed", [s if s in _TIER1_OCP else pytest.param(s, marks=pytest.mark.slow)
                                  for s in range(12)])
def test_random_ocp_matches_reference(seed):
    want, got, _ = _ocp_case(seed)
    if seed not in _ROUNDING_DECIDED:
        _assert_same(want, got)
        return
    _assert_same(want, got, iterations=False)
    mod, system, phase = _random_ocp(seed, _REF)
    opts = RefOptions(tol=1e-8, max_iter=200, mu_strategy=STRATEGIES[seed % 3], kkt_solver="dense")
    _, dense = ref_ipm.solve(system, mod.constant_guess(phase, 0.1), opts)
    counts = sorted({want["iterations"], dense["iterations"]})
    assert dense["status"] == 0 and len(counts) == 2, counts
    assert counts[0] <= got["iterations"] <= counts[1], (got["iterations"], counts)


@pytest.mark.parametrize("seed", [s if s in _TIER1_HEAD else pytest.param(s, marks=pytest.mark.slow)
                                  for s in range(8)])
def test_random_lagrangian_head_matches_reference(seed):
    want, got, (ref_sys, port_sys) = _head_case(seed)
    lay_r, lay_p = ref_layout(ref_sys), structured_layout(port_sys)
    assert lay_p.krylov_rank == lay_r.krylov_rank > 0
    _assert_same(want, got)


@pytest.mark.parametrize("kkt_solver", ["block", "pallas"])
def test_adaptive_lqr_matches_reference(kkt_solver):
    """``mu_strategy="adaptive"`` on the 4x5 LQR, through the block core and
    the kernels' plain versions (``"pallas"`` on CPU tensors)."""
    opts = dict(mu_strategy="adaptive", kkt_solver=kkt_solver)
    ref_sys, ref_phase = build_lqr(ref_lobatto, 4, 5)
    _, want = ref_ipm.solve(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]],
                            RefOptions(**opts))
    system, phase = build_lqr(port_lobatto, 4, 5)
    _, got = ipm.solve(system, [port_lobatto.constant_guess(phase, 0), [0.0]], IPOptions(**opts),
                       device="cpu", dtype=torch.float64)
    _assert_same(want, got)


def _bang_bang(radau):
    """``tools/compare_mu.py``'s bang-bang gate: the min-time double
    integrator on a 3x6 Radau mesh, |u| <= 1, t_f in [0.5, 6]."""
    system = radau.System(0)
    phase = system.new_phase(["x", "v"], ["u"])
    x, v = phase.x
    (u,) = phase.u
    phase.set_dynamics([v, u])
    phase.set_integral([1])
    phase.set_phase_constraint([u, phase.t], [-1.0, 0.5], [1.0, 6.0],
                               bang_bang_control=[True, False])
    phase.set_boundary_condition([0.0, 0.0], [1.0, 0.0], 0.0, None)
    phase.set_discretization(3, 6)
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    guess = radau.linear_guess(phase, 0.5)
    guess.t_f = 3.0
    return system, guess


def test_adaptive_bang_bang_matches_reference():
    """The LOQO rule where it moves mu: the port takes the JAX package's
    iterations to its objective (1e-9 relative), with mu at every
    iteration within 1e-5 relative (the rule takes mu to tol/10 at
    iteration 0, and the first step at that mu moves by ~1e-6 between any
    two factorizations, as on seed 7; a wrong rule moves mu by O(1))."""
    opts = dict(tol=1e-8, mu_strategy="adaptive", kkt_solver="block")
    _, want = ref_ipm.solve(*_bang_bang(ref_radau), RefOptions(**opts))
    _, got = ipm.solve(*_bang_bang(port_radau), IPOptions(**opts), device="cpu",
                       dtype=torch.float64)
    _assert_same(want, got)
    mu, mu_ref = np.asarray(got["trace"])[:, 1], np.asarray(want["trace"])[:, 1]
    assert len(np.unique(mu_ref)) > 3  # the rule retargets mu as it goes
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-5, atol=0)
