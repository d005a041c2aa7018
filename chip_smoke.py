#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--reps N]

Phases (each prints its own line; any failed check raises and the script
exits non-zero):

0. device: the card's name, count and power limit; TF32 off.
1. build: compile the block-arrow KKT kernels from
   ``pockit_tpu_torch/csrc/block_arrow_kkt.cu`` (build seconds, ptxas
   registers / shared memory / spills per kernel).
2. kernels against their plain torch versions at the LQR bench shapes
   (nb=10, ni=16, nr=25 -> 32, B=16384 float32; B=1024 float64), with a
   few lanes made indefinite so the retry ladder and acceptance flags run;
   times of each kernel and its plain version with CUDA events; then all
   three kernels at ragged shapes (``RAGGED``: every built interior and
   reduced size, run-time sizes, reduced lane tiles, more interval
   blocks than an apply_up CTA has warps; 1001 lanes, a multiple of
   neither the factor's lane tile, 32 nor 128) in both types.
3. float64 LQR (10x10 LGL, B=256) through the kernels against the
   analytic objective J1 * x0^2.
4. the float32 bench workload: B=16384 LQR instances, two-stage drained
   solve, one warm-up and ``--reps`` timed repetitions on fresh x0 draws.
   The options are bench.py's, with ``newton_residual_rtol`` from
   ``--residual-rtol`` (default 0: off; bench.py keeps 1e-2).

The line before the last lists each kernel's launches on the main path
(and per batch), its error against the plain version, both times, and
its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for the type (``cuda_kkt.kernel_cost``,
from this run's shapes and retries). The last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import time

import numpy as np

J1 = 0.2319139744522318  # LQR objective at x0 = 1 (reference README)
CPU_ONLY = "torch.cuda.is_available() is false: this smoke run needs a CUDA card"


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def build_lqr(lobatto, mesh=10, num_point=10):
    system = lobatto.System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([-x + u])
    phase.set_integral([x**2 + 0.1 * u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(mesh, num_point)
    system.set_phase([phase])
    system.set_objective(phase.I[0] + x_f**2 / 2)
    return system, phase


def kernel_inputs(core, B, dtype, seed, device, nb=10, ni=16, nr=25, lanes=None):
    """Batch-last padded blocks (the bench shapes by default), with the
    interiors' spectra set: eigenvalues in [1, 10], except every 7th lane's
    block 3 with one eigenvalue at -0.5 (the retry ladder 0 -> 0.1 -> 1.0
    accepts it at 1.0) and every 61st lane's block 5 with one at -50
    (rejected at every rung); plus the apply right-hand sides. Every
    accepted block is well conditioned, so kernel and plain version differ
    only by rounding. ``lanes`` cuts the padded lanes to that count."""
    import torch

    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((B, nb, ni, ni)))
    lam = rng.uniform(1.0, 10.0, (B, nb, ni))
    lam[::7, 3, 0] = -0.5
    lam[::61, 5, 0] = -50.0
    K_ii = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    K_ir = rng.standard_normal((B, nb, ni, nr)) * 0.3
    A = rng.standard_normal((B, nr, nr))
    K_rr = A @ np.swapaxes(A, -1, -2) + 4 * nr * np.eye(nr)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Kt = core.pad_move(t(K_ii), t(K_ir), t(K_rr))
    if lanes is not None:
        Kt = tuple(k[..., :lanes].contiguous() for k in Kt)
    BT = Kt[0].shape[-1]
    b_i = t(rng.standard_normal((nb, core.ni_p, BT)))
    b_r = t(rng.standard_normal((core.nr_p, BT)))
    return Kt, b_i, b_r


def max_err(a, b):
    """(max abs error, max error relative to its own lane's scale) over the
    entries both hold finite; raises if NaN positions differ. The lane axis
    is the last: each lane's errors are divided by that lane's largest |b|
    in the tensor, so large values in one lane cannot hide a wrong lane."""
    import torch

    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError("NaN positions differ between kernel and plain version")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0, 0.0
    lanes = b.shape[-1]
    d = torch.where(fin, (a - b).abs(), 0.0).reshape(-1, lanes)
    scale = torch.where(fin, b.abs(), 0.0).reshape(-1, lanes).amax(0)
    rel = d / torch.clamp_min(scale, torch.finfo(b.dtype).tiny)
    return d.max().item(), rel.max().item()


def cuda_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_kernels(B, dtype, rtol, timed):
    """Each kernel against its plain version on the same card inputs."""
    import torch

    from pockit_tpu_torch.solver import cuda_kkt as ck

    core = ck.make_core(np.arange(160).reshape(10, 16), np.arange(160, 185), 185)
    Kt, b_i, b_r = kernel_inputs(core, B, dtype, seed=7, device="cuda")
    kw = dict(ni_real=16, nr_real=25, pivot_rtol=2.0 * float(np.sqrt(np.finfo(np.float32).eps)),
              delta_floor=0.1, attempts=3)
    delta = torch.zeros(Kt[0].shape[-1], dtype=dtype, device="cuda")
    cpu = lambda ts: tuple(x.cpu() for x in ts)
    fac = ck.factor_blocks(*Kt, delta, **kw)
    fac_ref = ck.factor_blocks_ref(*Kt, delta, **kw)
    torch.cuda.synchronize()
    res = {}
    names = ["L_i", "sc_i", "X_ir", "L_r", "sc_r", "piv", "d_blk"]
    ok_k, ok_p = fac[5][3, :B] > 0.5, fac_ref[5][3, :B] > 0.5
    if not torch.equal(ok_k, ok_p):
        raise AssertionError("acceptance flags differ between kernel and plain version")
    if not torch.equal(fac[6][:, :B], fac_ref[6][:, :B]):
        raise AssertionError("per-block delta levels differ between kernel and plain version")
    retried = int((fac[6][3, :B] > 0).sum())
    rejected = int((~ok_k).sum())
    # extra Cholesky attempts of the interior retry ladder, from the levels
    # factored (0 -> 0.1 -> 1.0): what this data adds to the factor's work
    d_int = fac[6][:-1, :B].double()
    chol_retries = int(torch.where(
        d_int > 0, 1 + torch.round(torch.log10(d_int / kw["delta_floor"])), 0).sum())
    if retried == 0 or rejected == 0:
        raise AssertionError("the inputs did not exercise the retry ladder and rejection")
    # values are compared on the accepted lanes: a rejected lane's factors
    # are garbage by design (huge or NaN) and the solver never uses them
    lanes = torch.nonzero(ok_k)[:, 0].cpu()
    errs = [max_err(a[..., :B][..., lanes], b[..., :B][..., lanes])
            for a, b in zip(cpu(fac), cpu(fac_ref))]
    res["factor"] = max(e[0] for e in errs), max(e[1] for e in errs)
    L_i, sc_i, X_ir, L_r, sc_r, _, _ = fac
    down = ck.apply_down(L_i, sc_i, Kt[1], b_i, b_r)
    down_ref = ck.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r)
    up = ck.apply_up(L_r, sc_r, down[1], X_ir, down[0])
    up_ref = ck.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0])
    torch.cuda.synchronize()
    for name, got, want in (("apply_down", down, down_ref), ("apply_up", up, up_ref)):
        e = [max_err(a[..., :B].cpu()[..., lanes], b[..., :B].cpu()[..., lanes])
             for a, b in zip(got, want)]
        res[name] = max(x[0] for x in e), max(x[1] for x in e)
    for name, (_, rel) in res.items():
        if not rel <= rtol:
            raise AssertionError(f"{name}: kernel vs plain per-lane relative error {rel:.3e} > {rtol:.0e}")
    print(f"phase 2 kernels {str(dtype)} B={B}: " + ", ".join(
        f"{k} max_abs_err={v[0]:.3e} max_lane_rel_err={v[1]:.3e}" for k, v in res.items())
        + f"; factor detail " + ", ".join(f"{n}={e[1]:.2e}" for n, e in zip(names, errs))
        + f"; lanes retried={retried} rejected={rejected} (tolerance per-lane rel {rtol:.0e})", flush=True)
    times = {}
    if timed:
        times["factor"] = (cuda_ms(lambda: ck.factor_blocks(*Kt, delta, **kw), 20),
                           cuda_ms(lambda: ck.factor_blocks_ref(*Kt, delta, **kw), 2))
        times["apply_down"] = (cuda_ms(lambda: ck.apply_down(L_i, sc_i, Kt[1], b_i, b_r), 50),
                               cuda_ms(lambda: ck.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r), 3))
        times["apply_up"] = (cuda_ms(lambda: ck.apply_up(L_r, sc_r, down[1], X_ir, down[0]), 50),
                             cuda_ms(lambda: ck.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0]), 3))
        print("phase 2 times B=%d %s: " % (B, dtype) + ", ".join(
            f"{k} kernel {v[0]:.3f} ms plain {v[1]:.3f} ms" for k, v in times.items()), flush=True)
    return res, times, chol_retries


# (nb, ni, nr) of the ragged checks and what each exercises, padded sizes
# in brackets (ni_p, nr_p): built interior bodies [24, 8, 32], run-time
# interior bodies [40, 64], fewer factor lanes per CTA than a full tile
# [32 or 64 with nr_p 64]; every apply_up body [8, 16, 24; 32 at the bench
# shapes; run-time 40, 48, 64]; 40 blocks, 200 interior rows over the 8
# warps of an apply_up CTA
RAGGED = ((6, 20, 37), (6, 5, 7), (6, 30, 60), (6, 37, 45), (6, 64, 64), (40, 5, 7), (6, 12, 13),
          (6, 9, 21))


def phase_ragged(dtype, rtol, nb, ni, nr):
    """The three kernels against their plain versions at a ragged shape:
    ``nb`` interiors of ``ni`` and a reduced block of ``nr``, padded to
    multiples of 8, on 1001 lanes (a multiple of neither the factor's lane
    tile, 32 nor 128). Each kernel takes the kernel outputs before it, and
    its plain version the same inputs. Same flags, levels and per-lane
    tolerance as the bench shapes."""
    import torch

    from pockit_tpu_torch.solver import cuda_kkt as ck

    lanes = 1001
    core = ck.make_core(np.arange(nb * ni).reshape(nb, ni), np.arange(nb * ni, nb * ni + nr),
                        nb * ni + nr)
    Kt, b_i, b_r = kernel_inputs(core, lanes, dtype, seed=11, device="cuda", nb=nb, ni=ni, nr=nr,
                                 lanes=lanes)
    kw = dict(ni_real=ni, nr_real=nr, pivot_rtol=2.0 * float(np.sqrt(np.finfo(np.float32).eps)),
              delta_floor=0.1, attempts=3)
    delta = torch.zeros(lanes, dtype=dtype, device="cuda")
    fac = ck.factor_blocks(*Kt, delta, **kw)
    fac_ref = ck.factor_blocks_ref(*Kt, delta, **kw)
    torch.cuda.synchronize()
    ok = fac[5][3] > 0.5
    if not torch.equal(ok, fac_ref[5][3] > 0.5) or not torch.equal(fac[6], fac_ref[6]):
        raise AssertionError("ragged: flags or per-block levels differ from the plain version")
    if bool(ok.all()) or not bool((fac[6][3] > 0).any()):
        raise AssertionError("ragged: the inputs did not exercise the retry ladder and rejection")
    lanes_ok = torch.nonzero(ok)[:, 0].cpu()
    rel = lambda got, want: max(max_err(a.cpu()[..., lanes_ok], b.cpu()[..., lanes_ok])[1]
                                for a, b in zip(got, want))
    L_i, sc_i, X_ir, L_r, sc_r, _, _ = fac
    down = ck.apply_down(L_i, sc_i, Kt[1], b_i, b_r)
    down_ref = ck.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r)
    up = ck.apply_up(L_r, sc_r, down[1], X_ir, down[0])
    up_ref = ck.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0])
    torch.cuda.synchronize()
    errs = {"factor": rel(fac, fac_ref), "apply_down": rel(down, down_ref), "apply_up": rel(up, up_ref)}
    launch = ck.apply_up_launch(nb, core.ni_p, core.nr_p, lanes, dtype)
    print(f"phase 2 ragged {dtype} nb={nb} ni_p={core.ni_p} nr_p={core.nr_p} lanes={lanes} "
          f"(factor lanes per CTA {ck.factor_tile_lanes(core.ni_p, core.nr_p, dtype)}, apply_up body "
          f"{launch['body']} warps {launch['warps']}): "
          + " ".join(f"{k} max_lane_rel_err={v:.3e}" for k, v in errs.items())
          + f"; lanes accepted {int(ok.sum())} (tolerance per-lane rel {rtol:.0e})", flush=True)
    if not max(errs.values()) <= rtol:
        raise AssertionError(f"ragged {dtype}: kernel vs plain per-lane error above {rtol:.0e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed repetitions of phase 4")
    ap.add_argument("--batch", type=int, default=16384, help="phase 4 batch size")
    ap.add_argument("--residual-rtol", type=float, default=0.0,
                    help="phase 4 newton_residual_rtol (bench.py runs the default 1e-2)")
    args = ap.parse_args()

    import torch

    # -- phase 0: device ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit(CPU_ONLY)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)

    import pockit_tpu_torch.lobatto as lobatto
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver import IPOptions
    from pockit_tpu_torch.solver import _build, cuda_kkt

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build_info()
    print(f"phase 1 build: {info['seconds']:.1f} s nvcc ({time.perf_counter() - t0:.1f} s with load)",
          flush=True)
    for line in info["ptxas"].splitlines():
        if "Function properties" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip().replace("ptxas info    : ", ""), flush=True)

    # -- phase 2: kernels against plain versions ------------------------------
    # tolerance: FMA contraction and a different rounding of 1/sqrt, then
    # amplified by the factorization (blocks are well conditioned here)
    errs32, times, retries32 = phase_kernels(16384, torch.float32, 1e-4, timed=True)
    phase_kernels(1024, torch.float64, 1e-11, timed=False)
    for nb, ni, nr in RAGGED:
        phase_ragged(torch.float32, 1e-4, nb, ni, nr)
        phase_ragged(torch.float64, 1e-11, nb, ni, nr)

    system, phase = build_lqr(lobatto)
    x0, _ = preprocess(system, [lobatto.constant_guess(phase, 0), [0.0]])
    fixed = system.compiled.phases[0].fixed_vals

    def draw(rng, B, dtype):
        bc = np.tile(fixed, (B, 1))
        bc[:, 0] = rng.uniform(0.5, 1.5, B)
        return bc, torch.as_tensor(bc, dtype=dtype, device="cuda")

    # -- phase 3: float64 LQR through the kernels ------------------------------
    rng = np.random.default_rng(3)
    bc, bc_t = draw(rng, 256, torch.float64)
    cuda_kkt.reset_launches()
    z0 = torch.as_tensor(np.tile(x0, (256, 1)), dtype=torch.float64, device="cuda")
    res = ipm.solve_batch(system, z0, bc_overrides=(bc_t,),
                          optimizer_options=IPOptions(tol=1e-8, kkt_solver="pallas"))
    status = res.status.cpu().numpy()
    want = J1 * bc[:, 0] ** 2
    rel = np.abs(res.obj.cpu().numpy() - want) / want
    print(f"phase 3 float64 LQR B=256: converged {np.mean(status == 0):.4f} "
          f"iters {res.iterations.cpu().numpy().mean():.2f} max rel obj err {rel.max():.3e} "
          f"launches {dict(cuda_kkt.LAUNCHES)}", flush=True)
    if not (status == 0).all() or rel.max() > 1e-8 or min(cuda_kkt.LAUNCHES.values()) == 0:
        raise AssertionError("float64 LQR through the kernels failed")

    # -- phase 4: the float32 bench workload -----------------------------------
    B = args.batch
    # the options of bench.py (copied: bench.py imports jax), except the
    # Newton residual acceptance: in IEEE float32 this LQR's condensed K
    # (1/delta_c = 8.4e4 entries) leaves every solve's residual near or
    # above 1e-2 * ||rhs|| from rounding alone, so the test escalates
    # sound steps; 0 switches it off, as the option documents. Both
    # packages apply the same rule for the same value.
    opts_fast = IPOptions(tol=5e-6, max_iter=2, refine_steps=3, max_ls=4, soc=False,
                          feasibility_fallback=False, pallas_attempts=3,
                          newton_residual_rtol=args.residual_rtol)
    opts_drain = IPOptions(tol=5e-6, max_iter=80, refine_steps=3, pallas_attempts=3,
                           newton_residual_rtol=args.residual_rtol)
    x0b = torch.as_tensor(np.tile(x0, (B, 1)), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)

    def solve_all(bc_t):
        return ipm.solve_batch_drained(
            system, x0b, bc_overrides=(bc_t,), optimizer_options=opts_drain,
            first_pass_options=opts_fast, drain_frac=8, max_drain_rounds=4,
            return_first_pass_mask=True,
        )

    t0 = time.perf_counter()
    solve_all(draw(rng, B, torch.float32)[1])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    walls, convs, firsts, iters, parity = [], [], [], [], []
    launches = {k: 0 for k in cuda_kkt.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.reps):
        bc, bc_t = draw(rng, B, torch.float32)
        cuda_kkt.reset_launches()
        t0 = time.perf_counter()
        status, obj, it, z, done1 = solve_all(bc_t)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for k, v in cuda_kkt.LAUNCHES.items():
            launches[k] += v
        ok = status == 0
        convs.append(float(ok.mean()))
        firsts.append(float(done1.mean()))
        iters.append(float(it.mean()))
        parity.append(float(np.max(np.abs(obj - J1 * bc[:, 0] ** 2)[ok], initial=0.0)))
        if not np.isfinite(z.cpu().numpy()).all():
            raise AssertionError("non-finite primal solution")
    wall = float(np.median(walls))
    metrics = dict(
        batch=B, reps=args.reps, newton_residual_rtol=args.residual_rtol, converged_frac=float(np.mean(convs)),
        first_pass_frac=float(np.mean(firsts)), mean_iters=float(np.mean(iters)),
        max_objective_parity_error=float(np.max(parity)), wall_s_per_batch=wall,
        walls=walls, solves_per_s=B / wall, warmup_s=warm_s,
        max_memory_allocated=int(torch.cuda.max_memory_allocated()),
        launches=launches, device=name, power_limit=smi,
    )
    print("phase 4 float32 bench: " + json.dumps(metrics), flush=True)
    if metrics["converged_frac"] < 0.99:
        raise AssertionError(f"converged_frac {metrics['converged_frac']} < 0.99")
    if metrics["max_objective_parity_error"] > 5e-6:
        raise AssertionError("objective parity above the float32 gate 5e-6")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")

    src = "pockit_tpu_torch/csrc/block_arrow_kkt.cu"
    replaces = {"factor": "pockit_tpu/solver/pallas_kkt.py:160",
                "apply_down": "pockit_tpu/solver/pallas_kkt.py:385",
                "apply_up": "pockit_tpu/solver/pallas_kkt.py:403"}
    # the bound of the timed phase-2 calls: bench shapes, float32, B=16384
    cost = {k: cuda_kkt.kernel_cost(k, 10, 16, 32, 16384, torch.float32,
                                    retries32 if k == "factor" else 0)
            for k in replaces}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "launches_per_batch": launches[k] / args.reps,
         "max_abs_err": errs32[k][0], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": cost[k]["bound_ms"], "bound_by": cost[k]["bound_by"],
         "bytes": cost[k]["bytes"], "ops": cost[k]["ops"], "library_ms": None}
        for k in replaces]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
