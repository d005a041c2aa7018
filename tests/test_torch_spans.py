"""The solver's spans and counters (``pockit_tpu_torch.utils.profiling``) on
the CPU, on the float64 LQR of the README (6x6 LGL) at B=4:

- inside ``recording()`` every phase of a solve is recorded: ``ipm.init``
  and ``ipm.finalize`` once a solve, ``ipm.assemble``, ``ipm.newton``,
  ``ipm.line_search`` and ``ipm.update`` once a trip, inside the trip's
  seconds, and at least one factorization a trip, on each KKT path;
- recording and profiling change no answer, bit for bit;
- with neither active a span makes no ``record_function`` call;
- under ``profile_trace`` each span is a range of the trace, the in-trip
  ones inside an ``ipm.iteration``, one ``ipm.iteration`` a trip as before;
- a drain round is an ``ipm.drain_round``; a phase closes when the solve
  raises; a second recording does not open inside the first;
- on the 3-phase Goddard rocket of ``benchmark/configs/goddard_radau3x4x7``
  (cut to 2 intervals of 5 nodes a phase, B=2, the singular arc's thrust
  guessed near its lower bound): each block assembly
  (``ipm.assemble.blocks``) dispatches three phase groups
  (``kkt.phase_groups``), the box on the singular arc cuts steps
  (``ipm.bound_cut`` > 0), and that counter reads the device only inside a
  recording: one read a trip more, none without.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pockit_tpu_torch.lobatto as lobatto
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.utils import count, profile_trace, profiling, recording, span

from benchmark.configs import goddard_radau3x4x7 as goddard_config

B = 4
IN_TRIP = ("ipm.assemble", "ipm.newton", "ipm.line_search", "ipm.update")
ONCE = ("ipm.init", "ipm.finalize")


@pytest.fixture(scope="module")
def lqr():
    """The README LQR on 6x6 LGL, B lanes of x(0) in [0.5, 1.5]."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    system = lobatto.System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,), (u,) = phase.x, phase.u
    phase.set_dynamics([-x + u])
    phase.set_integral([x**2 + 0.1 * u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(6, 6)
    system.set_phase([phase])
    system.set_objective(phase.I[0] + x_f**2 / 2)
    x0, _ = preprocess(system, [lobatto.constant_guess(phase, 0), [0.0]])
    bc = np.tile(system.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.linspace(0.5, 1.5, B)
    yield system, torch.as_tensor(np.tile(x0, (B, 1))), (torch.as_tensor(bc),)
    torch.set_num_threads(n)


def _solve(lqr, kkt_solver="auto"):
    system, z0, bc = lqr
    return ipm.solve_batch(system, z0, bc_overrides=bc, device="cpu",
                           optimizer_options=IPOptions(tol=1e-8, kkt_solver=kkt_solver))


def _same(a, b):
    for f in ("z", "y", "obj", "status", "iterations", "kkt_error", "trace"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def runs(lqr, tmp_path_factory):
    """The same solve with nothing active, inside a recording, and under
    ``profile_trace`` and a recording together; the trace's ranges."""
    plain = _solve(lqr)
    with recording():
        recorded = _solve(lqr)
    with profile_trace(str(tmp_path_factory.mktemp("trace"))) as prof, recording():
        profiled = _solve(lqr)
    with open(prof.trace_path) as f:
        ranges = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return plain, recorded, profiled, ranges


@pytest.mark.parametrize("kkt_solver", ["auto", "pallas", "dense"])
def test_recording_holds_every_phase_of_a_solve(lqr, kkt_solver):
    with recording() as rec:
        res = _solve(lqr, kkt_solver)
    spans, counters = rec["spans"], rec["counters"]
    trips = spans["ipm.iteration"]["calls"]
    assert trips == int(res.iterations.max()) + 1  # the last trip finds it converged
    for name in ONCE:
        assert spans[name]["calls"] == 1 and spans[name]["s"] > 0
    for name in IN_TRIP:
        assert spans[name]["calls"] == trips and spans[name]["s"] > 0
    assert sum(spans[name]["s"] for name in IN_TRIP) <= spans["ipm.iteration"]["s"]
    assert counters["ipm.factor_tries"] >= trips
    # the block-arrow paths assemble K by phase groups: one phase of one
    # interval degree here, one group an assembly
    blocks = {"ipm.assemble.blocks"} if kkt_solver != "dense" else set()
    assert set(spans) == {"ipm.iteration", *ONCE, *IN_TRIP, *blocks}
    if blocks:
        assert spans["ipm.assemble.blocks"]["calls"] == trips
        assert spans["ipm.assemble.blocks"]["s"] <= spans["ipm.assemble"]["s"]
        assert counters["kkt.phase_groups"] == trips
    assert counters["ipm.bound_cut"] == 0  # no bounded variable


def test_answers_are_the_same_recorded_profiled_or_neither(runs):
    plain, recorded, profiled, _ = runs
    _same(plain, recorded)
    _same(plain, profiled)


def test_with_nothing_active_a_span_calls_no_record_function(lqr, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("ipm.newton") is span("ipm.update") is profiling.phases()
    res = _solve(lqr)
    assert int(res.status.max()) == 0
    count("ipm.factor_tries")  # no recording: nothing to add to, no error


def test_profile_trace_holds_each_span_inside_its_trip(runs):
    _, _, res, ranges = runs
    by = {}
    for e in ranges:
        by.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    trips = by["ipm.iteration"]
    assert len(trips) == int(res.iterations.max()) + 1
    inside = lambda a, b: any(lo <= a and b <= hi for lo, hi in trips)
    for name in IN_TRIP:
        assert len(by[name]) == len(trips)
        assert all(inside(a, b) for a, b in by[name]), name
    for name in ONCE:
        assert len(by[name]) == 1 and not inside(*by[name][0]), name


def test_each_drain_round_is_a_span(lqr):
    system, z0, bc = lqr
    opts = IPOptions(tol=1e-8)
    with recording() as rec:
        status, *_ = ipm.solve_batch_drained(system, z0, bc_overrides=bc, optimizer_options=opts,
                                             first_pass_iters=1, device="cpu")
    assert (status == 0).all()
    # one iteration leaves every lane to the drain: one round of 8 lanes
    assert rec["spans"]["ipm.drain_round"]["calls"] == 1
    assert rec["spans"]["ipm.init"]["calls"] == 2


def test_a_phase_closes_when_the_work_raises_and_recordings_do_not_nest():
    with recording() as rec:
        with pytest.raises(RuntimeError), profiling.phases() as mark:
            mark("a")
            mark("b")
            raise RuntimeError
        with pytest.raises(RuntimeError, match="already open"), recording():
            pass
        with span("c"):
            count("k", 3)
    assert rec["spans"]["a"]["calls"] == rec["spans"]["b"]["calls"] == rec["spans"]["c"]["calls"] == 1
    assert rec["counters"] == {"k": 3} and profiling._REC is None
    count("k")  # closed: nothing to add to
    assert rec["counters"] == {"k": 3}


@pytest.fixture(scope="module")
def goddard():
    """The Goddard rocket of the benchmark's configuration on 2x5 Radau
    phases, two lanes of launch mass m0 in [0.97, 1.03], guessed with the
    singular arc's thrust near its lower bound (0.05), so that the first
    steps meet the box."""
    path = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
    cfg = {**json.loads((path / "goddard_radau3x4x7.json").read_text()),
           "intervals": 2, "points": 5}
    cfg["guess"] = {**cfg["guess"], "phases": [dict(p) for p in cfg["guess"]["phases"]]}
    cfg["guess"]["phases"][1]["u"] = 0.05
    problem = goddard_config.build(cfg)
    m0 = np.random.default_rng(2**31 + 17).uniform(0.97, 1.03, 2)
    z0 = torch.as_tensor(np.tile(problem.guesses["config"], (2, 1)))
    bc = tuple(torch.as_tensor(b) for b in goddard_config.boundary(problem, {"m0": m0}))
    return problem.system, z0, bc


def _goddard_solve(goddard, max_iter=6):
    system, z0, bc = goddard
    return ipm.solve_batch(system, z0, bc_overrides=bc, device="cpu",
                           optimizer_options=IPOptions(tol=1e-7, max_iter=max_iter))


def test_goddard_assembles_three_phase_groups_and_cuts_steps_at_its_box(goddard):
    with recording() as rec:
        _goddard_solve(goddard)
    trips = rec["spans"]["ipm.iteration"]["calls"]
    assert rec["spans"]["ipm.assemble.blocks"]["calls"] == trips
    assert rec["counters"]["kkt.phase_groups"] == 3 * trips
    assert 0 < rec["counters"]["ipm.bound_cut"] <= 2 * trips


def test_the_bound_cut_reads_the_device_only_inside_a_recording(goddard, monkeypatch):
    """Every read of a tensor's value on the host counted, the solve makes
    exactly one more a trip inside a recording (the counter's) than with
    nothing active: no read, so no sync, is added when nobody records."""
    reads = [0]
    for name in ("__int__", "__bool__", "__float__", "item", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            (lambda f: lambda self, *a: (reads.__setitem__(0, reads[0] + 1),
                                                         f(self, *a))[1])(real))
    _goddard_solve(goddard)
    off = reads[0]
    with recording() as rec:
        _goddard_solve(goddard)
    assert reads[0] - 2 * off == rec["spans"]["ipm.iteration"]["calls"]
