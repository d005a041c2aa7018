"""The Goddard rocket's configuration, its plain reference and its cell
(``goddard_f64_sweep``): the reference against COPS 3.0's published
altitude and against itself; the cell run on the CPU at two lanes, correct
as it is and not correct with its answers broken (as
``test_bench_faults.py`` breaks them); the float32 control not correct on
the card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import goddard_radau3x4x7 as reference
from benchmark.tests import test_bench_faults as faults

ROOT = Path(__file__).resolve().parents[2]
CELL = "goddard_f64_sweep"


def _cfg():
    return json.loads((ROOT / "benchmark" / "configs" / "goddard_radau3x4x7.json").read_text())


def test_configuration_states_its_transcription_sizes():
    """The JSON's NLP sizes and block-arrow sizes are those of the port's
    build: 12 interval blocks of 25 interior unknowns, a reduced block of
    60, as the solver factors them."""
    from benchmark.configs import goddard_radau3x4x7 as port_config
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import IPOptions

    cfg = _cfg()
    compiled, solve, _ = ipm._solver_for(port_config.build(cfg).system, IPOptions())
    assert (compiled.L, compiled.m) == (cfg["nlp"]["L"], cfg["nlp"]["m"])
    kb = cfg["kkt_blocks"]
    assert solve.block_shape == (kb["nb"], kb["ni"], kb["nr"])


def test_nominal_meets_the_published_altitude():
    """COPS 3.0 reports h(tf) = 1.01283 (five places) for the Goddard rocket;
    the nominal optimum at this mesh is within 1e-5 of it, its KKT residual
    with the bound complementarity at rounding."""
    nom = reference.load_nominal()
    assert abs(float(nom["h_f"]) - _cfg()["h_f_published"]) < 1e-5
    assert float(nom["kkt_norm"]) < 1e-12


def test_nominal_starts_from_a_feasible_point():
    cfg = _cfg()
    god = reference.Goddard(cfg)
    w = reference.feasible_start(cfg, god)
    assert float(god.constraints(w, torch.tensor(1.0, dtype=torch.float64)).abs().max()) < 1e-12


def test_nominal_is_reproducible(tmp_path):
    """``make_nominal`` makes the committed data file again."""
    rec = reference.make_nominal(_cfg(), tmp_path / "nominal.npz")
    nom = reference.load_nominal()
    assert abs(float(rec["h_f"]) - float(nom["h_f"])) < 1e-12
    np.testing.assert_allclose(rec["w"], nom["w"], atol=1e-9)


@pytest.fixture(scope="module")
def swept():
    cfg = _cfg()
    params = {"m0": np.array([0.97, 0.99, 1.0, 1.01, 1.03])}
    return cfg, params, reference.solve(cfg, params)


def test_altitude_grows_with_the_launch_mass(swept):
    """With the dry mass fixed, a heavier launch carries more propellant:
    h(tf) rises with m0 across the traffic's dispersion, every lane
    converged to its complementarity."""
    _, _, out = swept
    h_f = out["statics"][:, -1]
    assert np.all(np.diff(h_f) > 0)
    assert h_f[2] == pytest.approx(float(reference.load_nominal()["h_f"]), abs=1e-12)
    assert np.all(out["kkt_norm"] < 1e-9)


def test_reference_is_feasible_in_its_own_transcription(swept):
    cfg, params, out = swept
    assert np.all(reference.feasibility(cfg, params, out) < 1e-12)
    # its thrust keeps off the box at this mesh: 0 < u < T_max
    assert 0.0 < out["u"].min() and out["u"].max() < cfg["derived"]["T_max"]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.goddard_radau3x4x7\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    mods = set(out.stdout.split())
    assert not mods & {"jax", "jaxlib", "flax", "pockit_tpu", "pockit_tpu_torch"}


def _run():
    return harness.run_cell(CELL, 2**31 + 5, 0.5, False, device="cpu", batch=2)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"obj_gap", "sol_gap", "feas"}


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_broken_run_is_not_correct(how, monkeypatch):
    faults._patch(monkeypatch, how)
    r = _run()
    assert not r["correct"], r["checks"]


def _one_call(seed, batch, control, device="cuda"):
    """``correct`` and the checks of one drained call of the cell, judged as
    a run judges its window. The kind's set-up warms every shape up; a test
    needs only its first step, the batch's guess: a float32 control call
    runs out all four of its drain rounds, about 3 minutes on the card."""
    cell = harness.load_cell(CELL)
    drv = harness.CellRun(cell, seed, device=device, batch=batch, control=control)
    drv.state["z0"] = drv.guess()
    answers = harness.host_arrays([drv.call()])
    j = harness.judge(cell, drv, answers, seed)
    return harness.verdict(j["checks"], cell.mix["limits"], j["reference_kkt_norm"])


@pytest.mark.gpu
def test_program_is_correct_and_control_is_not():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = 2**31 + 99
    prog, prog_rows = _one_call(seed, 64, False)
    ctl, ctl_rows = _one_call(seed, 64, True)
    assert prog, prog_rows
    assert not ctl, ctl_rows
