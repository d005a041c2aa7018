"""Where the port and the reference part on the float32 Goddard rocket at
the reference CPU gate's options (tests/test_end_to_end/test_float32_gates.py:
tol 1e-5, Mehrotra, no delta_w floor).

The reference converges there in 14 iterations and the port does not
(``test_torch_float32_gates.py`` runs ``tools/bench_gates.py``'s float32
options instead). This file holds the first iteration of both side by side:
the same rung of the escalation, the same assembled system to float32
rounding, and a system so ill-conditioned that this rounding alone moves
the first direction, the affine one, by more than a tenth of its size,
before any Mehrotra code runs. ``pytest -s`` prints the figures.

The reference's system comes from its own dump hook (``POCKIT_DUMP_KKT``,
the first iteration's K blocks and affine rhs, taken on its Pallas path
in interpret mode) in a subprocess with JAX's float32 default, as the JAX
package's float32 gates run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import pockit_tpu_torch.radau as port_radau
import pockit_tpu_torch.solver.structured as structured
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.transcription.kkt import make_block_kkt

from chip_smoke import build_goddard

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
import jax
jax.config.update("jax_platforms", "cpu")
import json
import numpy as np
import pockit_tpu.radau as radau
from pockit_tpu.optimizer import ipm
from pockit_tpu.solver import IPOptions
from chip_smoke import build_goddard
assert not jax.config.jax_enable_x64
system, guess = build_goddard(radau)
opts = IPOptions(tol=1e-5, max_iter=1, refine_steps=3, mu_strategy="mehrotra",
                 kkt_solver="pallas")
_, info = ipm.solve(system, guess, optimizer_options=opts)
print(json.dumps({"trace0": np.asarray(info["trace"])[0].tolist()}))
"""


def _reference_first_iteration(path):
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "POCKIT_DUMP_KKT": str(path)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return np.load(path), json.loads(out.stdout.strip().splitlines()[-1])["trace0"]


def _port_first_iteration(monkeypatch):
    """The port's first iteration at the same options on the CPU block
    path: every factorization the escalation tried and every solve."""
    tries, solves = [], []
    make = structured.make_block_arrow_core

    def spy(*a, **k):
        factor, apply = make(*a, **k)

        def factor_spy(K_ii, K_ir, K_rr):
            tries.append((K_ii[0].clone(), K_ir[0].clone(), K_rr[0].clone()))
            return factor(K_ii, K_ir, K_rr)

        def apply_spy(core, b):
            x = apply(core, b)
            solves.append((b[0].clone(), x[0].clone()))
            return x

        return factor_spy, apply_spy

    monkeypatch.setattr(structured, "make_block_arrow_core", spy)
    system, guess = build_goddard(port_radau)
    opts = IPOptions(tol=1e-5, max_iter=1, refine_steps=3, mu_strategy="mehrotra")
    _, info = ipm.solve(system, guess, opts, device="cpu", dtype=torch.float32)
    return system, tries, solves, info["trace"][0]


def _dense(system, K_ii, K_ir, K_rr):
    """The condensed K of one lane from its blocks, in float64."""
    blk = make_block_kkt(system)
    n = system.compiled.L
    red = np.asarray(blk.layout.reduced)
    K = np.zeros((n + 1, n + 1))
    for b, ib in enumerate(np.asarray(blk.interior_pad)):
        K[np.ix_(ib, ib)] += K_ii[b]
        K[np.ix_(ib, red)] += K_ir[b]
        K[np.ix_(red, ib)] += K_ir[b].T
    K[np.ix_(red, red)] += K_rr
    return K[:n, :n]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_float32_goddard_first_direction_is_decided_by_rounding(tmp_path, monkeypatch):
    """Iteration 0 at the reference gate's options, both packages in
    float32 on the CPU: the same KKT error and escalation rung (delta_w
    1.19e-2, the ladder's sixth), the same step length, the same affine rhs
    to 1e-6 and the same K blocks to 1e-5 of their largest entry (each
    package's own derivative program rounds its sums in its own order).
    The condensed K's condition number is above 1e8, so float32 rounding
    decides the direction: solved exactly (float64), the two packages'
    float32 systems give affine directions more than 10% apart, and the
    port's own float32 solve is more than 10% from its exact one. The
    direction differs before the probe, sigma or the corrector see it."""
    ref, ref_trace0 = _reference_first_iteration(tmp_path / "kkt0.npz")
    system, tries, solves, trace0 = _port_first_iteration(monkeypatch)
    kkt, _, alpha, delta_w = (float(v) for v in trace0[:4])
    assert [kkt, alpha, delta_w] == [float(v) for v in ref_trace0[:1] + ref_trace0[2:4]]
    assert float(ref["dreg"]) == 0.0 and delta_w > 0.0
    # the rungs 0, 1.19e-6, ... failed the pivot test; the last, delta_w, held
    assert len(tries) > 1 and len(solves) > len(tries)
    K_ii, K_ir, K_rr = (t.numpy() for t in tries[-1])
    rhs, dz_aff = (t.numpy() for t in solves[len(tries) - 1])
    eye = lambda n: np.eye(n, dtype=np.float32)
    ref_ii = ref["K_ii"] + np.float32(delta_w) * eye(K_ii.shape[-1])
    ref_rr = ref["K_rr"] + np.float32(delta_w) * eye(K_rr.shape[-1])
    K_port = _dense(system, K_ii, K_ir, K_rr)
    K_ref = _dense(system, ref_ii, ref["K_ir"], ref_rr)
    x_port = np.linalg.solve(K_port, rhs.astype(np.float64))
    x_ref = np.linalg.solve(K_ref, ref["rhs"].astype(np.float64))
    assert _rel(rhs, ref["rhs"]) < 1e-6
    assert max(_rel(K_ii, ref_ii), _rel(K_ir, ref["K_ir"]), _rel(K_rr, ref_rr)) < 1e-5
    assert min(np.linalg.cond(K_port), np.linalg.cond(K_ref)) > 1e8
    figures = dict(
        rhs=_rel(rhs, ref["rhs"]), K_ii=_rel(K_ii, ref_ii), K_ir=_rel(K_ir, ref["K_ir"]),
        K_rr=_rel(K_rr, ref_rr), cond_port=np.linalg.cond(K_port), cond_ref=np.linalg.cond(K_ref),
        exact_port_vs_ref=_rel(x_port, x_ref), dz_aff_vs_exact=_rel(dz_aff, x_port),
    )
    print("float32 Goddard iteration 0: " + json.dumps(figures))
    assert figures["exact_port_vs_ref"] > 0.1
    assert figures["dz_aff_vs_exact"] > 0.1
