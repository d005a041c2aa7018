"""Batched MPC sweep (BASELINE.json config 5): thousands of LQR instances
with perturbed boundary conditions solved at once, then a warm-started
replan step, the pattern of real-time MPC on accelerators.

x(0) ~ U(0.5, 1.5) from ``default_rng(0)``; the replan's drift N(0, 0.02).
Float32 at ``IPOptions(tol=2e-5, max_iter=60)``, or float64 at the
defaults.

Run: python -m pockit_tpu_torch.examples.mpc_sweep [batch] [--dtype float64] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from pockit_tpu_torch.examples.lqr import build
from pockit_tpu_torch.lobatto import constant_guess
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.solver import IPOptions


def draws(fixed_vals, B, seed=0):
    """The sweep's boundary values: x(0) ~ U(0.5, 1.5), then the replan's
    drifted copy."""
    rng = np.random.default_rng(seed)
    bc = np.tile(fixed_vals, (B, 1))
    bc[:, 0] = rng.uniform(0.5, 1.5, B)
    bc2 = bc.copy()
    bc2[:, 0] += rng.normal(0, 0.02, B)
    return bc, bc2


def options(dtype):
    """The example's options: float32 at tol 2e-5 and 60 iterations, float64
    at the solver's defaults (``None``)."""
    return IPOptions(tol=2e-5, max_iter=60) if dtype == torch.float32 else None


def _wait(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=2048)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    args = ap.parse_args(argv)
    B, device, dtype = args.batch, args.device, getattr(torch, args.dtype)
    system, phase = build()
    x0, _ = preprocess(system, [constant_guess(phase, 0), [0.0]])
    bc, bc2 = draws(system.compiled.phases[0].fixed_vals, B)
    opts = options(dtype)
    t = lambda a: torch.as_tensor(a, device=device, dtype=dtype)

    t0 = time.perf_counter()
    res = ipm.solve_batch(system, t(np.tile(x0, (B, 1))), bc_overrides=(t(bc),),
                          optimizer_options=opts)
    _wait(device)
    t_cold = time.perf_counter() - t0
    conv = float((res.status == 0).double().mean())
    print(f"cold sweep: B={B} {args.dtype} {t_cold:.3f}s  converged={conv:.1%}")

    # MPC replan: boundary conditions drift, warm-start from the solutions
    t0 = time.perf_counter()
    res2 = ipm.solve_batch(system, res.z, bc_overrides=(t(bc2),), optimizer_options=opts)
    _wait(device)
    t_warm = time.perf_counter() - t0
    conv2 = float((res2.status == 0).double().mean())
    print(
        f"warm replan: {t_warm:.3f}s  converged={conv2:.1%}  "
        f"mean iters {float(res2.iterations.double().mean()):.2f}  "
        f"({B / t_warm:.0f} replans/s)"
    )
    return res, res2


if __name__ == "__main__":
    main()
