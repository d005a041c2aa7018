"""The port's drained float64 solve of the COPS 3.0 Goddard rocket against
the benchmark's plain reference (``benchmark/reference/goddard_radau3x4x7``:
its own three-phase LGR transcription and a primal-dual interior-point
method in plain torch), on the CPU.

The configuration of ``benchmark/configs/goddard_radau3x4x7.json`` is cut
here to 2 intervals of 5 nodes a phase; the reference makes its nominal
optimum at that mesh, then follows each lane's launch mass m0 from it. The
port solves three seeded draws m0 ~ U(0.97, 1.03) cold from the
configuration's guess with the cell's options. Compared: objective, states,
statics and phase 2's thrust; the pins of phases 1 and 3 and the box of
phase 2 on the port's answer; the port's answer in the reference's
transcription. (At 2 intervals of 4 nodes a phase some such draws leave
both packages' cold solves unconverged.)
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pockit_tpu_torch.radau as radau
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import postprocess
from pockit_tpu_torch.solver import IPOptions

from benchmark.configs import goddard_radau3x4x7 as port_config
from benchmark.reference import goddard_radau3x4x7 as reference

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
# the largest gap of each part over the reference's largest magnitude: the
# port stops at tol 1e-7, where the singular arc leaves the thrust, and the
# states and switching times that follow it, loosely determined
GAPS = {"obj": 1e-8, "h": 1e-5, "v": 5e-3, "m": 1e-3, "u": 5e-2, "statics": 1e-3}


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _solve(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _solve(tmp_path_factory):
    cfg = {**json.loads((BENCH / "configs" / "goddard_radau3x4x7.json").read_text()),
           "intervals": 2, "points": 5}
    mix = json.loads((BENCH / "traffic" / "goddard_sweep_f64.json").read_text())
    nominal = tmp_path_factory.mktemp("goddard") / "nominal.npz"
    reference.make_nominal(cfg, nominal)
    m0 = np.random.default_rng(2**31 + 41).uniform(0.97, 1.03, 3)
    params = {"m0": m0}
    ref = reference.solve(cfg, params, nominal=nominal)
    problem = port_config.build(cfg)
    z0 = torch.as_tensor(np.tile(problem.guesses["config"], (len(m0), 1)))
    bc = tuple(torch.as_tensor(b) for b in port_config.boundary(problem, params))
    status, obj, _, z, _ = ipm.solve_batch_drained(
        problem.system, z0, bc_overrides=bc, device="cpu",
        optimizer_options=IPOptions(**mix["options"]),
        first_pass_options=IPOptions(**mix["first_pass"]), return_first_pass_mask=True)
    return cfg, params, ref, problem, status, obj, z


def test_both_converged(solved):
    """Every lane of the port converged; the reference's KKT residual, its
    bound complementarity included, is under 1e-9 on every lane."""
    *_, ref, _, status, _, _ = solved
    assert (np.asarray(status) == 0).all()
    assert np.all(ref["kkt_norm"] < 1e-9)


@pytest.mark.parametrize("part", sorted(GAPS))
def test_port_meets_the_reference(solved, part):
    *_, ref, problem, _, obj, z = solved
    got = {"obj": np.asarray(obj, dtype=np.float64), **port_config.decode(problem, z)}
    gap = np.abs(got[part] - ref[part]).max() / np.abs(ref[part]).max()
    assert gap < GAPS[part], gap


def test_pins_and_box_hold_on_the_port_answer(solved):
    """Full thrust in phase 1 and none in phase 3, exactly, once the fixed
    values are substituted back; phase 2's thrust within 0 <= u <= 3.5."""
    *_, problem, _, _, z = solved
    t_max = 3.5
    for lane in z.numpy():
        phases = postprocess(radau.Variable, problem.system, lane, False)[:3]
        np.testing.assert_array_equal(phases[0].u[0], t_max)
        np.testing.assert_array_equal(phases[2].u[0], 0.0)
        assert 0.0 <= phases[1].u[0].min() and phases[1].u[0].max() <= t_max


def test_port_answer_is_feasible_in_the_reference_transcription(solved):
    cfg, params, _, problem, _, _, z = solved
    feas = reference.feasibility(cfg, params, port_config.decode(problem, z))
    assert np.all(feas < 1e-7), feas
