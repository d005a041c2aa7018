"""The IPOPT shim and the scipy adapter of the port against the JAX
package's on the CPU.

- ``ipopt._translate``: the same ``IPOptions``, field by field, for a table
  of IPOPT option dicts (``mu_strategy="adaptive"`` becomes Mehrotra in
  both), the same warning for an option with no equivalent;
- the shim's float64 LQR solves within 1e-6 of the README objective J1,
  the second through Mehrotra probing for IPOPT's ``adaptive``;
- ``scipy.solve`` (``trust-constr`` over the port's dense callbacks) on a
  small LQR against the reference's: ``fun`` within 1e-8, ``x`` within
  1e-6 (both run scipy's solver on callbacks that agree to rounding).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
from pockit_tpu.optimizer import ipopt as ref_ipopt
from pockit_tpu.optimizer import scipy as ref_scipy
from pockit_tpu_torch.optimizer import ipopt, scipy
from pockit_tpu_torch.solver import IPOptions

from test_torch_frontend import build_lqr, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

J1 = 0.2319139744522318  # LQR objective at x(0) = 1 (reference README)

OPTION_TABLE = [
    {},
    {"tol": 1e-6},
    {"max_iter": 50, "mu_init": 1e-2},
    {"bound_relax_factor": 1e-9},
    {"mu_strategy": "adaptive"},
    {"mu_strategy": "monotone", "tol": 1e-7},
    {"print_level": 0, "sb": "yes", "linear_solver": "ma57", "hessian_approximation": "exact",
     "output_file": "ipopt.out", "print_timing_statistics": "no"},
]


@pytest.mark.parametrize("options", OPTION_TABLE, ids=lambda o: ",".join(o) or "empty")
def test_translate_matches_reference(options):
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no option of the table is unknown
        got = ipopt._translate(options, torch.float64)
        want = ref_ipopt._translate(options)
    assert isinstance(got, IPOptions)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if options.get("mu_strategy") == "adaptive":
        assert got.mu_strategy == "mehrotra"


def test_translate_passes_options_through_and_follows_the_dtype():
    opts = IPOptions(tol=3e-7)
    assert ipopt._translate(opts) is opts and ipopt._translate(None) is None
    assert ipopt._translate({}, torch.float32).tol == 2e-5
    assert ipopt._translate({"tol": 1e-3}, torch.float32).tol == 1e-3


def test_unknown_option_warns_as_the_reference():
    with pytest.warns(UserWarning, match="has no equivalent; ignored") as got:
        ipopt._translate({"acceptable_tol": 1e-4, "tol": 1e-6}, torch.float64)
    with pytest.warns(UserWarning, match="has no equivalent; ignored") as want:
        ref_ipopt._translate({"acceptable_tol": 1e-4, "tol": 1e-6})
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert str(got[0].message) == "IPOPT option 'acceptable_tol' has no equivalent; ignored"


def test_shim_solves_the_lqr():
    system, phase = build_lqr(port_lobatto)
    [_, var_s], info = ipopt.solve(
        system, [port_lobatto.constant_guess(phase, 0), [0.0]],
        {"tol": 1e-8, "max_iter": 80, "print_level": 0, "sb": "yes"},
        device="cpu", dtype=torch.float64,
    )
    assert info["status"] == 0
    assert abs(info["obj_val"] - J1) < 1e-6
    assert abs(float(var_s[0]) - info["x"][-1]) == 0.0
    # IPOPT's adaptive barrier rule takes the native Mehrotra probing
    _, info = ipopt.solve(system, [port_lobatto.constant_guess(phase, 0), [0.0]],
                          {"mu_strategy": "adaptive"}, device="cpu", dtype=torch.float64)
    assert info["status"] == 0 and abs(info["obj_val"] - J1) < 1e-6
    assert [o.mu_strategy for o in system.compiled._ipm_cache] == ["monotone", "mehrotra"]


def test_scipy_matches_reference():
    opts = {"maxiter": 500, "gtol": 1e-10}
    ref_sys, ref_phase = build_lqr(ref_lobatto, 4, 5)
    port_sys, port_phase = build_lqr(port_lobatto, 4, 5)
    [ref_p, ref_s], want = ref_scipy.solve(
        ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]], dict(opts))
    [var_p, var_s], got = scipy.solve(
        port_sys, [port_lobatto.constant_guess(port_phase, 0), [0.0]], dict(opts), device="cpu")
    # both stop on a convergence test (which one, gtol or xtol, can part
    # on the last iteration's rounding)
    assert got.success and want.success and got.status in (1, 2)
    assert abs(got.fun - want.fun) <= 1e-8
    np.testing.assert_allclose(got.x, want.x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(var_p.data, ref_p.data, rtol=0, atol=1e-6)
    assert abs(float(var_s[0]) - float(ref_s[0])) <= 1e-6
    # the 4x5 mesh's own optimum, a little above the 10x10 mesh's J1
    assert abs(got.fun - J1) < 1e-3
