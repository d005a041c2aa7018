"""The ops hooks of the solver against the JAX package on the CPU, on the
float64 LQR of the README (6x6 LGL):

- ``IPOptions.live_metrics``: one ``[ipm]`` line per IPM trip, the JAX
  package's scalar line for one lane (on the kernel path) and its batched
  aggregate for more (on the block path);
  the values each line is printed from equal the reference's within 1e-6
  relative (abs 1e-10 for values at the rounding floor, e.g. theta
  ~1e-16), except a KKT error below ``KKT_FLOOR``, which must be below it
  in both: there the error is rounding amplified by the 1/delta_c rows of
  K, and the reference's own paths disagree (iteration 1 of this LQR:
  7.5e-8 block, 8.5e-8 dense, 4.1e-8 Pallas; the port's block path 1.06e-7);
- ``POCKIT_IPM_DEBUG_TRACE``: the Newton-direction trace rows
  ``[|rhs|, max|K|, |dz|, max|dz|, delta_w, step_cap]`` on the block and
  dense paths, each entry within 1e-8 relative or within twice the gap
  between the reference's own block and dense paths, whichever is larger:
  a Newton step solves K (condition ~1e8 from its 1/delta_c rows), so dz
  carries rounding the two reference paths do not share (|dz| 1.4e-7
  apart at iteration 0, 2% at iteration 1, where dz is 2e-5), and every
  later row inherits it;
- ``POCKIT_DUMP_KKT``: the kernel path's first-iteration inputs (on the
  CPU the kernels' plain versions run; the reference runs its Pallas
  kernels in interpret mode) with the reference's keys and shapes, each
  array within 1e-10 of the reference's relative to its largest entry
  (K carries entries of 1e8);
- ``utils.profile_trace``: a Chrome trace naming the IPM's iterations and
  its torch ops.

Under ``jax.vmap`` the JAX package's host callback fires once per lane
(jax 0.9 unrolls a batched ``debug.callback``), so its batched solve calls
the live-metrics sink once per lane and trip; the tests gather those
calls by trip and compare them with the port's one call per trip.

The hooks are module constants read when a solver is built, and built
solvers are cached per system and options: each test builds fresh systems.
"""

import contextlib
import functools
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu.solver.ipm as ref_solver
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.solver.ipm as port_solver
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.optimizer._common import preprocess as ref_preprocess
from pockit_tpu.solver import IPOptions as RefOptions
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.utils import profile_trace

from test_torch_frontend import build_lqr, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

F64 = dict(device="cpu", dtype=torch.float64)
KKT_FLOOR = 1e-6


def _assert_rows_close(rows, want):
    """Live-metrics rows ``[kkt, mu, alpha, delta_w, theta, phi]`` against
    the reference's (module docstring)."""
    rows, want = np.atleast_2d(rows), np.atleast_2d(want)
    floor = want[:, 0] < KKT_FLOOR
    assert (rows[floor, 0] < KKT_FLOOR).all()
    np.testing.assert_allclose(rows[~floor, 0], want[~floor, 0], rtol=1e-6)
    np.testing.assert_allclose(rows[:, 1:], want[:, 1:], rtol=1e-6, atol=1e-10)


def _pair(B=None):
    """Fresh 6x6 LQR systems of both packages, the reference's x0 and, for
    a batch, ``B`` lanes of x(0) in [0.5, 1.5]."""
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    port_sys, port_phase = build_lqr(port_lobatto, 6, 6)
    guesses = ([ref_lobatto.constant_guess(ref_phase, 0), [0.0]],
               [port_lobatto.constant_guess(port_phase, 0), [0.0]])
    if B is None:
        return ref_sys, port_sys, guesses
    x0, _ = ref_preprocess(ref_sys, guesses[0])
    bc = np.tile(ref_sys.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.linspace(0.5, 1.5, B)
    return ref_sys, port_sys, np.tile(x0, (B, 1)), bc


def _recording_sink(monkeypatch, module, calls, echo=False):
    """Replace ``module._emit_live_metrics`` by a sink that records its
    arguments as numpy arrays and, with ``echo``, prints as the original."""
    original = module._emit_live_metrics

    def sink(it, row, finished_prev):
        calls.append((np.asarray(it), np.asarray(row), np.asarray(finished_prev)))
        if echo:
            original(it, row, finished_prev)

    monkeypatch.setattr(module, "_emit_live_metrics", sink)


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def scalar_runs(tmp_path_factory):
    """One single solve of the LQR per package on the kernel path (the
    port's plain versions, the reference's Pallas kernels in interpret
    mode) with ``live_metrics`` on and the KKT dump set: each package's
    printed lines, its sink's calls, its info and its dump file."""
    path = tmp_path_factory.mktemp("scalar")
    ref_sys, port_sys, (g_ref, g_port) = _pair()
    out = {}
    for name, module, run in (
        ("ref", ref_solver, lambda: ref_ipm.solve(
            ref_sys, g_ref, RefOptions(tol=1e-8, live_metrics=True, kkt_solver="pallas"))),
        ("port", port_solver, lambda: ipm.solve(
            port_sys, g_port, IPOptions(tol=1e-8, live_metrics=True, kkt_solver="pallas"), **F64)),
    ):
        calls, printed = [], io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
            _recording_sink(mp, module, calls, echo=True)
            mp.setattr(module, "_DUMP_KKT", str(path / f"{name}.npz"))
            _, info = run()
            jax.effects_barrier()
        out[name] = dict(lines=printed.getvalue().splitlines(), calls=calls, info=info,
                         dump=str(path / f"{name}.npz"))
    return out


def test_live_metrics_scalar_lines_match_reference(scalar_runs):
    ref, port = scalar_runs["ref"], scalar_runs["port"]
    lines, calls = port["lines"], port["calls"]
    assert all(l.startswith("[ipm] it=") for l in lines)
    # one line per trip: the converging trip prints too, then the loop ends
    assert len(lines) == port["info"]["iterations"] + 1 == len(ref["lines"]) == len(calls)
    its = [int(re.match(r"\[ipm\] it=\s*(\d+)", l).group(1)) for l in lines]
    assert its == [int(re.match(r"\[ipm\] it=\s*(\d+)", l).group(1)) for l in ref["lines"]]
    assert its == list(range(len(lines)))
    # the values behind the lines, and the line format on the port's values
    for (it, row, done), (it_r, row_r, _) in zip(calls, ref["calls"]):
        assert it.shape == (1,) and row.shape == (1, 6) and not done[0]
        assert int(it[0]) == int(it_r)
        _assert_rows_close(row[0], row_r)
    for line, (it, row, done) in zip(lines, calls):
        assert _printed(ref_solver._emit_live_metrics, it[0], row[0], done[0]) == [line]


def test_live_metrics_batched_aggregates_match_reference(monkeypatch, capsys):
    B = 4
    ref_sys, port_sys, z0, bc = _pair(B)
    ref_calls, port_calls = [], []
    _recording_sink(monkeypatch, ref_solver, ref_calls)
    _recording_sink(monkeypatch, port_solver, port_calls, echo=True)
    want = ref_ipm.solve_batch(ref_sys, z0, bc_overrides=(jnp.asarray(bc),),
                               optimizer_options=RefOptions(tol=1e-8, live_metrics=True))
    jax.effects_barrier()
    capsys.readouterr()
    got = ipm.solve_batch(port_sys, z0, bc_overrides=(bc,),
                          optimizer_options=IPOptions(tol=1e-8, live_metrics=True), **F64)
    lines = capsys.readouterr().out.splitlines()
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    # the reference's per-lane calls: B per trip, in no fixed lane order
    # (the callbacks are unordered effects); lanes are matched by phi,
    # which the lanes' x(0) set apart
    assert len(ref_calls) == B * len(port_calls)
    for t, (it, row, done) in enumerate(port_calls):
        chunk = ref_calls[t * B : (t + 1) * B]
        it_r = np.array([int(c[0]) for c in chunk])
        row_r = np.stack([c[1] for c in chunk])
        done_r = np.array([bool(c[2]) for c in chunk])
        p, r = np.argsort(row[:, 5]), np.argsort(row_r[:, 5])
        np.testing.assert_array_equal(it[p], it_r[r])
        np.testing.assert_array_equal(done[p], done_r[r])
        active = ~done[p]
        assert active.any()
        _assert_rows_close(row[p][active], row_r[r][active])
    assert len(port_calls) == int(got.iterations.max()) + 1
    # the printed lines: one per trip, the reference sink's batched format
    assert len(lines) == len(port_calls)
    monkeypatch.undo()
    for line, (it, row, done) in zip(lines, port_calls):
        assert line.startswith("[ipm] it~")
        assert _printed(ref_solver._emit_live_metrics, it, row, done) == [line]


@functools.cache
def _ref_debug_traces():
    """The reference's debug-trace rows of the LQR's single solve on its
    block and dense paths."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_solver, "_DEBUG_TRACE", True)
        out = {}
        for kkt_solver in ("block", "dense"):
            ref_sys, _, (g_ref, _) = _pair()
            _, info = ref_ipm.solve(ref_sys, g_ref, RefOptions(tol=1e-8, kkt_solver=kkt_solver))
            out[kkt_solver] = info["trace"]
    return out


@pytest.mark.parametrize("kkt_solver", ["block", "dense"])
def test_debug_trace_rows_match_reference(monkeypatch, kkt_solver):
    monkeypatch.setattr(port_solver, "_DEBUG_TRACE", True)
    _, port_sys, (_, g_port) = _pair()
    _, info = ipm.solve(port_sys, g_port, IPOptions(tol=1e-8, kkt_solver=kkt_solver), **F64)
    ref = _ref_debug_traces()
    rows, want = info["trace"], ref[kkt_solver]
    assert rows.shape == want.shape and info["iterations"] >= 2
    # [|rhs|, max|K|, |dz|, max|dz|, delta_w, step_cap]: step_cap is
    # 1e3 (1 + |z|), max|K| carries 1/delta_c, not the standard row
    assert (rows[:, 5] >= 1e3).all() and (rows[:, 1] > 1e3).all()
    spread = np.abs(ref["block"] - ref["dense"])
    spread[:, 1] = 0.0  # max|K|: block-arrow blocks against the dense K
    assert (np.abs(rows - want) <= np.maximum(1e-8 * np.abs(want), 2 * spread)).all(), (
        rows, want, spread)
    # the initial point's own entries carry no step's rounding
    np.testing.assert_allclose(rows[0, [0, 1, 4, 5]], want[0, [0, 1, 4, 5]], rtol=1e-8)


def test_kkt_dump_matches_reference(scalar_runs, monkeypatch, tmp_path):
    """The scalar solve writes one lane's arrays, as the reference's; the
    batched solve leads with the lane axis, and its lane 0 (the configured
    x(0)) is the scalar solve's."""
    B = 3
    _, port_sys, z0, bc = _pair(B)
    bc[0] = port_sys.compiled.phases[0].fixed_vals
    monkeypatch.setattr(port_solver, "_DUMP_KKT", str(tmp_path / "port_b.npz"))
    ipm.solve_batch(port_sys, z0, bc_overrides=(bc,),
                    optimizer_options=IPOptions(tol=1e-8, kkt_solver="pallas"), **F64)

    keys = ["K_ii", "K_ir", "K_rr", "rhs", "dreg", "cap", "z", "y", "D", "bc"]
    with np.load(scalar_runs["ref"]["dump"]) as r, np.load(scalar_runs["port"]["dump"]) as p, \
            np.load(tmp_path / "port_b.npz") as pb:
        assert sorted(p.files) == sorted(r.files) == sorted(pb.files) == sorted(keys)
        for k in keys:
            assert p[k].shape == r[k].shape and pb[k].shape == (B,) + r[k].shape, k
            _assert_scaled_close(p[k], r[k], k)
            _assert_scaled_close(pb[k][0], r[k], k)
        assert r["K_ii"].ndim == 3 and r["K_ii"].shape[-1] % 8 == 0
        assert not np.allclose(pb["bc"][2], pb["bc"][0])


def _assert_scaled_close(got, want, name):
    """Within 1e-10 of ``want`` relative to its largest entry."""
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale, err_msg=name)


def test_profile_trace_names_the_ipm_ops(tmp_path):
    _, port_sys, (_, g_port) = _pair()
    with profile_trace(str(tmp_path / "trace")) as prof:
        _, info = ipm.solve(port_sys, g_port, IPOptions(tol=1e-8), **F64)
    assert info["status"] == 0
    with open(prof.trace_path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    # one range per IPM trip, and the torch ops inside them
    assert names.count("ipm.iteration") == info["iterations"] + 1
    assert any(n.startswith("aten::linalg_cholesky") for n in names)
    assert any(n.startswith("aten::") for n in names)
