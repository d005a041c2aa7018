"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small batch, through the port's own solves, with the solve
that the window calls wrapped to break its answers in one way: the state
returned unchanged (the guess or warm start comes back), half of the batch
left out (its answers copied from the other half), or one lane's answer
altered where it is produced (its solution and objective 1% off). One chip
per cell: there is no exchange between chips to leave out. The unbroken run
comes out correct.
"""

import pytest

from benchmark import harness

SIZES = {"lqr_f32_sweep": 16, "lqr_f64_mpc": 16, "orbit_f64_replan": 2}


def _break(z_in, z, obj, how):
    if how == "unchanged":
        return z_in.clone(), obj
    z, obj = z.clone(), obj.clone() if hasattr(obj, "clone") else obj.copy()
    B = z.shape[0]
    if how == "half":
        z[B // 2 :] = z[: B - B // 2]
        obj[B // 2 :] = obj[: B - B // 2]
    else:
        z[0] *= 1.01
        obj[0] *= 1.01
    return z, obj


def _patch(monkeypatch, how):
    from pockit_tpu_torch.optimizer import ipm

    real_drained, real_batch = ipm.solve_batch_drained, ipm.solve_batch

    def drained(system, guess, *a, **kw):
        status, obj, it, z, *rest = real_drained(system, guess, *a, **kw)
        z, obj = _break(guess, z, obj, how)
        return (status, obj, it, z, *rest)

    def batch(system, guess, *a, **kw):
        res = real_batch(system, guess, *a, **kw)
        z, obj = _break(guess, res.z, res.obj, how)
        return res._replace(z=z, obj=obj)

    monkeypatch.setattr(ipm, "solve_batch_drained", drained)
    monkeypatch.setattr(ipm, "solve_batch", batch)


def _run(cell):
    return harness.run_cell(cell, 2**31 + 5, 0.5, False, device="cpu", batch=SIZES[cell])


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_broken_run_is_not_correct(cell, how, monkeypatch):
    _patch(monkeypatch, how)
    r = _run(cell)
    assert not r["correct"], r["checks"]
