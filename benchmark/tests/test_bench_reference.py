"""The plain references against what is known of their problems."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import collocation, lqr_lgl10x10, orbit_radau40x10

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("family", ["lgl", "lgr"])
@pytest.mark.parametrize("n", [3, 6, 10])
def test_tables_integrate_polynomials_exactly(family, n):
    """Quadrature exact to degree 2n-3 (LGL) or 2n-2 (LGR); the integration
    matrix exact on polynomials of degree n-1."""
    x, w = getattr(collocation, family)(n)
    deg = 2 * n - 3 if family == "lgl" else 2 * n - 2
    for k in range(deg + 1):
        exact = (1 - (-1) ** (k + 1)) / (k + 1)
        assert abs(w @ x**k - exact) < 1e-13
    rows = x[:-1] if family == "lgl" else x
    I = collocation.integration_matrix(x, rows)
    for k in range(n):
        exact = (rows ** (k + 1) - 1) / (k + 1)
        assert np.max(np.abs(I @ x**k - exact)) < 1e-13


def test_lqr_reference_meets_the_closed_form():
    """The README's J1 = 0.2319139744522318 at x0 = 1, J1 x0^2 elsewhere."""
    cfg = _cfg("lqr_lgl10x10")
    one = lqr_lgl10x10.unit_solution(cfg)
    assert abs(one["obj"] - cfg["J1"]) < 1e-12
    x0 = np.array([0.5, 1.0, 1.37])
    out = lqr_lgl10x10.solve(cfg, {"x0": x0})
    np.testing.assert_allclose(out["obj"], cfg["J1"] * x0**2, rtol=1e-12)
    assert out["x"].shape == (3, 89) and out["u"].shape == (3, 91)


def test_orbit_nominal_meets_the_published_radius():
    """The nominal optimum the reference made: r_f within 5e-5 of Bryson
    and Ho's 1.5253 (rounded to four places), KKT residual at rounding."""
    nom = orbit_radau40x10.load_nominal()
    assert abs(float(nom["r_f"]) - 1.5253) < 5e-5
    assert float(nom["kkt_norm"]) < 1e-12
    assert float(nom["min_h_phi"]) > 0  # a maximum in every node's control


def test_orbit_reference_replans_from_the_nominal():
    """A drifted start converges by Newton's method; the radius grows with
    r0; the reference's own solution is feasible in its transcription."""
    cfg = _cfg("orbit_radau40x10")
    params = {"r0": np.array([0.995, 1.02])}
    out = orbit_radau40x10.solve(cfg, params, chunk=2)
    assert np.all(out["kkt_norm"] < 1e-10)
    assert out["r_f"][1, 0] > float(orbit_radau40x10.load_nominal()["r_f"]) > out["r_f"][0, 0]
    feas = orbit_radau40x10.feasibility(cfg, params, out)
    assert np.all(feas < 1e-12)


def test_orbit_nominal_is_reproducible(tmp_path):
    """``make_nominal`` makes the committed data file again."""
    cfg = _cfg("orbit_radau40x10")
    torch.set_num_threads(4)
    rec = orbit_radau40x10.make_nominal(cfg, tmp_path / "nominal.npz")
    nom = orbit_radau40x10.load_nominal()
    assert abs(float(rec["r_f"]) - float(nom["r_f"])) < 1e-12
    np.testing.assert_allclose(rec["phi"], nom["phi"], atol=1e-9)
