"""The control, on the card: each cell's lower-precision path (the mix's
``control``) in the program's place comes out not correct, where the
program itself comes out correct, at a batch that a test run holds. The
cells' own sizes are read with ``benchmark/calibrate.py --control``."""

import pytest

from benchmark import harness

SIZES = {"lqr_f32_sweep": 2048, "lqr_f64_mpc": 2048, "orbit_f64_replan": 64}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_program_is_correct_and_control_is_not(cell):
    _card()
    seed = 2**31 + 99
    prog = harness.run_cell(cell, seed, 2.0, False, batch=SIZES[cell])
    ctl = harness.run_cell(cell, seed, 2.0, False, batch=SIZES[cell], control=True)
    assert prog["correct"], prog["checks"]
    assert not ctl["correct"], ctl["checks"]
