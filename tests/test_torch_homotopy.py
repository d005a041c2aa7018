"""Homotopy continuation in the port against the JAX package on the CPU:
the fixture of ``tests/test_parallel/test_homotopy.py`` (the README LQR
on 6x6 LGL, B=4 lanes ramping x(0) from 1 to targets 3..6 over 4 stages,
float64), built in both packages.

- Each stage's status equals the reference's; ``obj`` and ``z`` within
  1e-8 (relative for ``obj``, absolute for ``z``);
- kill and resume, and the ``checkpoint_every=2`` layout: the reference
  test's assertions;
- a sweep killed under one package resumes under the other, both ways,
  final ``obj`` within 1e-8 of the uninterrupted sweep's: the checkpoint
  directory is the same format and the fingerprint the same digest;
- a checkpoint of another sweep warns and is not resumed.

``-m gpu``: the kill and resume on the card at B=1024 through the kernels.
"""

import functools
import os

import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu.parallel.homotopy as ref_homotopy
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.parallel.homotopy as port_homotopy
from pockit_tpu.optimizer._common import preprocess as ref_preprocess
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.parallel import homotopy_sweep
from pockit_tpu_torch.parallel.homotopy import StageSummary
from pockit_tpu_torch.solver import cuda_kkt

from test_torch_frontend import build_lqr, one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

J1 = 0.2319139744522318  # LQR objective at x(0) = 1 (reference README)
F64 = dict(device="cpu", dtype=torch.float64)


class Killed(RuntimeError):
    pass


def die_after(stage):
    def on_stage(k, res):
        if k == stage:
            raise Killed

    return on_stage


def sweep_inputs(fixed_vals, x0, B, targets):
    """The reference fixture's stages: x(0) = 1 + lam (target - 1) for lam
    in 0.25, 0.5, 0.75, 1."""
    base_bc = np.tile(fixed_vals, (B, 1))
    stages = []
    for lam in np.linspace(0.25, 1.0, 4):
        bc = base_bc.copy()
        bc[:, 0] = 1.0 + lam * (targets - 1.0)
        stages.append((bc,))
    return np.tile(x0, (B, 1)), stages


@functools.cache
def _fixture():
    """Both packages' systems (one each for the module: the reference
    compiles its batched solver once per system and options), the guess
    batch, the stages, the targets and the reference's uninterrupted
    sweep."""
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    port_sys, _ = build_lqr(port_lobatto, 6, 6)
    x0, _ = ref_preprocess(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]])
    targets = np.array([3.0, 4.0, 5.0, 6.0])
    guess_b, stages = sweep_inputs(ref_sys.compiled.phases[0].fixed_vals, x0, 4, targets)
    ref = [
        (np.asarray(r.status), np.asarray(r.obj), np.asarray(r.z))
        for r in ref_homotopy.homotopy_sweep(ref_sys, guess_b, stages)
    ]
    return ref_sys, port_sys, guess_b, stages, targets, ref


@functools.cache
def _port_sweep():
    _, port_sys, guess_b, stages, _, _ = _fixture()
    return homotopy_sweep(port_sys, guess_b, stages, **F64)


def test_sweep_matches_reference_stage_by_stage():
    _, _, _, _, targets, ref = _fixture()
    got = _port_sweep()
    assert len(got) == len(ref) == 4
    for res, (status, obj, z) in zip(got, ref):
        np.testing.assert_array_equal(res.status.numpy(), status)
        np.testing.assert_allclose(res.obj.numpy(), obj, rtol=1e-8)
        np.testing.assert_allclose(res.z.numpy(), z, rtol=0, atol=1e-8)
    assert (got[-1].status == 0).all()
    np.testing.assert_allclose(got[-1].obj.numpy(), J1 * targets**2, rtol=1e-6)
    # later stages are warm-started: no more iterations than stage 0
    assert float(got[-1].iterations.double().mean()) <= float(got[0].iterations.double().mean())


def test_digest_is_the_references():
    _, _, guess_b, stages, _, _ = _fixture()
    want = ref_homotopy._sweep_digest(guess_b, stages)
    assert port_homotopy._sweep_digest(guess_b, stages) == want
    # tensors of either type hash as the caller's float64 values
    t_stages = [tuple(torch.as_tensor(a, dtype=torch.float64) for a in bc) for bc in stages]
    assert port_homotopy._sweep_digest(torch.as_tensor(guess_b), t_stages) == want


def test_kill_restart(tmp_path):
    _, port_sys, guess_b, stages, _, _ = _fixture()
    ref = _port_sweep()
    ck = str(tmp_path / "sweep")
    with pytest.raises(Killed):
        homotopy_sweep(port_sys, guess_b, stages, on_stage=die_after(1), checkpoint_path=ck,
                       **F64)
    # unattended restart: same call; stages 0-1 restored, 2-3 solved
    solved = []
    results = homotopy_sweep(port_sys, guess_b, stages, on_stage=lambda k, r: solved.append(k),
                             checkpoint_path=ck, **F64)
    assert solved == [2, 3]
    assert isinstance(results[0], StageSummary) and isinstance(results[1], StageSummary)
    assert results[1].z is not None and results[0].z is None
    np.testing.assert_allclose(results[1].obj, ref[1].obj.numpy(), rtol=1e-6)
    assert (results[-1].status == 0).all()
    assert results[-1].z.device.type == "cpu" and results[-1].z.dtype == torch.float64
    np.testing.assert_allclose(results[-1].obj.numpy(), ref[-1].obj.numpy(), rtol=1e-6)
    # a finished sweep resumes to a no-op
    again = homotopy_sweep(port_sys, guess_b, stages,
                           on_stage=lambda k, r: solved.append(("again", k)),
                           checkpoint_path=ck, **F64)
    assert solved == [2, 3]
    assert all(isinstance(r, StageSummary) for r in again)
    # a checkpoint from a DIFFERENT sweep is ignored, not resumed
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        fresh = homotopy_sweep(port_sys, guess_b, [stages[0]] * 2, checkpoint_path=ck, **F64)
    assert len(fresh) == 2 and not isinstance(fresh[0], StageSummary)


def test_checkpoint_incremental_stride(tmp_path):
    _, port_sys, guess_b, stages, targets, _ = _fixture()
    ck = str(tmp_path / "sweep_ck")
    # warm batch saved at stages 1 and 3 only; killed after stage 2's
    # commit -> warm.npz still holds stage 1
    with pytest.raises(Killed):
        homotopy_sweep(port_sys, guess_b, stages, on_stage=die_after(2), checkpoint_path=ck,
                       checkpoint_every=2, **F64)
    assert sorted(os.listdir(ck)) == [
        "manifest.npz", "stage_00000.npz", "stage_00001.npz", "stage_00002.npz", "warm.npz",
    ]
    stage1_mtime = os.path.getmtime(os.path.join(ck, "stage_00001.npz"))
    solved = []
    results = homotopy_sweep(port_sys, guess_b, stages, on_stage=lambda k, r: solved.append(k),
                             checkpoint_path=ck, checkpoint_every=2, **F64)
    # stage 2's warm batch was strided out: resume restarts at stage 2
    assert solved == [2, 3]
    assert isinstance(results[0], StageSummary) and isinstance(results[1], StageSummary)
    assert os.path.getmtime(os.path.join(ck, "stage_00001.npz")) == stage1_mtime
    assert (results[-1].status == 0).all()
    np.testing.assert_allclose(results[-1].obj.numpy(), J1 * targets**2, rtol=1e-6)


@pytest.mark.parametrize("killed_under", ["reference", "port"])
def test_resume_across_packages(tmp_path, killed_under):
    ref_sys, port_sys, guess_b, stages, _, ref = _fixture()
    ck = str(tmp_path / "sweep")
    sweeps = {
        "reference": lambda **kw: ref_homotopy.homotopy_sweep(ref_sys, guess_b, stages, **kw),
        "port": lambda **kw: homotopy_sweep(port_sys, guess_b, stages, **kw, **F64),
    }
    resumed_under = "port" if killed_under == "reference" else "reference"
    with pytest.raises(Killed):
        sweeps[killed_under](on_stage=die_after(1), checkpoint_path=ck)
    solved = []
    results = sweeps[resumed_under](on_stage=lambda k, r: solved.append(k), checkpoint_path=ck)
    assert solved == [2, 3]
    restored = (StageSummary if resumed_under == "port" else ref_homotopy.StageSummary)
    assert isinstance(results[0], restored) and isinstance(results[1], restored)
    np.testing.assert_array_equal(np.asarray(results[1].status), ref[1][0])
    np.testing.assert_allclose(np.asarray(results[1].obj), ref[1][1], rtol=1e-8)
    final = results[-1]
    obj = final.obj.numpy() if resumed_under == "port" else np.asarray(final.obj)
    assert (np.asarray(final.status) == 0).all()
    np.testing.assert_allclose(obj, ref[-1][1], rtol=1e-8)


@pytest.mark.gpu
def test_kill_restart_on_card(tmp_path):
    """B=1024 lanes, x(0) targets ~ U(3, 6), on the card through the
    kernels (``auto`` takes them at the 6x6 mesh's padded shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    B = 1024
    system, phase = build_lqr(port_lobatto, 6, 6)
    x0, _ = preprocess(system, [port_lobatto.constant_guess(phase, 0), [0.0]])
    targets = np.random.default_rng(1).uniform(3.0, 6.0, B)
    guess_b, stages = sweep_inputs(system.compiled.phases[0].fixed_vals, x0, B, targets)
    card = dict(device="cuda", dtype=torch.float64)
    ck = str(tmp_path / "sweep_card")
    cuda_kkt.reset_launches()
    with pytest.raises(Killed):
        homotopy_sweep(system, guess_b, stages, on_stage=die_after(1), checkpoint_path=ck, **card)
    solved = []
    results = homotopy_sweep(system, guess_b, stages, on_stage=lambda k, r: solved.append(k),
                             checkpoint_path=ck, **card)
    assert solved == [2, 3]
    assert min(cuda_kkt.LAUNCHES.values()) > 0, cuda_kkt.LAUNCHES
    final = results[-1]
    assert final.z.device.type == "cuda"
    assert (final.status == 0).all()
    np.testing.assert_allclose(final.obj.cpu().numpy(), J1 * targets**2, rtol=1e-6)
