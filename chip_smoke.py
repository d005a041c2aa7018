#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--reps N] [--gate-batch B]
    python3 chip_smoke.py --first-pass GATE [--device cpu] [--lanes N]

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
   neither the factor's lane tile, 32 nor 128) in both types; then at the
   padded shapes of phases 5 and 6 (``GATE_SHAPES``: the orbit's
   (40, 40, 128), Goddard's (12, 32, 64)), in both types, with the retry
   ladder on and off, on ``--gate-batch`` lanes, with times.
3. float64 LQR (10x10 LGL, B=256) through the kernels against the
   analytic objective J1 * x0^2.
4. the float32 bench workload: B=16384 LQR instances, two-stage drained
   solve, one warm-up and ``--reps`` timed repetitions on fresh x0 draws.
   The options are bench.py's, with ``newton_residual_rtol`` from
   ``--residual-rtol`` (default 0: off; bench.py keeps 1e-2).
5. the 40x10 Radau orbit transfer and 6. the 3-phase Goddard rocket, the
   two configurations of ``tools/bench_gates.py`` built with the port, at
   ``--gate-batch`` lanes (default 1024) with that tool's perturbations
   (lane 0 nominal) and options (first pass 60 iterations, drain 120,
   ``refine_steps=3``): float64 (tol 1e-7) through the kernels, gated on
   converged share >= 0.99 and lane 0 against the published optimum; then
   float32 (the tool's float32 options) through the kernels and through
   the plain block core (``kkt_solver="block"``), printed side by side and
   gated on finite results, lane 0 against the optimum at the JAX package's
   float32 gate tolerances, and the kernel path converging no fewer lanes
   than the block path less 1%. Each run must launch all three kernels at
   the phase's padded shape.
7. the refine sweep (``parallel.solve_refine_batch``) at
   ``tools/bench_refine_sweep.py``'s configuration: the 1-state cubic on a
   2x4 Radau mesh, B=4096, x0 ~ U(0.5, 1.5) from ``default_rng(5)``, 2
   rounds, in float32 (check tolerance 1e-5) and float64 (1e-8; gated on
   converged and passed shares >= 0.99), with ``auto`` on the card: wall,
   bucket-solve and error-statistics seconds (from the sweep's bucket
   records), host share, buckets, shares, each bucket shape's kernel
   launches; every bucket must take the kernels. Then the bang-bang double
   integrator of ``tests/test_parallel/test_refine_batch.py`` at B=32 in
   float64 (every instance buckets alone), held against its analytic
   optimum T* = 2 vp - v0 at 5e-4, every instance passed, more than one
   bucket. Once the pool below has drained, the kernels are held against
   their plain versions, and timed, at every padded shape each of the
   three sweeps took, one shape after another.
8. F1 on the card: the 42x10 Radau orbit (reduced block 132, past the
   kernels' 128) at B=64 in float64 under ``auto``: the chooser
   (``cuda_kkt.kernel_path``) says "block", no kernel launches, the lanes
   are finite, explicit ``kkt_solver="pallas"`` raises before any launch;
   and the chooser says "pallas" at the padded shapes of phases 4-6.

9. continuation and MPC, on the LQR 10x10 LGL through the kernels (run
   after phase 4, before the pool of phases 5-8): a. ``examples/mpc_sweep.py``
   (BASELINE config 5) at B=8192, a cold solve and one warm replan, in
   float32 at the example's options (reported) and float64 (gated:
   converged >= 0.99, objectives within 1e-6 of J1 x0^2); b.
   ``homotopy_sweep`` at B=8192 in float64, four stages to x(0) targets ~
   U(3, 6), uninterrupted, then killed after stage 1 and resumed (only
   stages 2-3 solve; objectives within 1e-6 of J1 target^2 and 1e-9 of the
   uninterrupted sweep); c. the IPOPT shim (J1 within 1e-6 through the
   kernels; ``adaptive`` takes Mehrotra); d. the scipy adapter over the
   dense callbacks on the card (J1 within 1e-6); e. ``live_metrics`` at
   B=256, one ``[ipm]`` line per IPM trip; f. ``profile_trace`` around one
   float32 replan: the device's busy seconds over the replan's wall
   (printed).

10. the multi-device layers and the solver artifacts, on the LQR 10x10 LGL
   through the kernels (after phase 9, before the pool): a. the sharded
   batch solve at B=16384 on a one-rank NCCL mesh, float64 (statuses equal
   to ``ipm.solve_batch``'s, z within 1e-12, n_converged == B) and at the
   float32 first-pass options (converged counts equal), then on two
   processes sharing the card over gloo, 8192 rows each, float64 (each
   launches all three kernels, every lane within 1e-10 of the unsharded
   solve, the reduced count the sum of the ranks'); b. the sharded
   structured solve of the 40x10 Radau orbit's condensed K at a random
   point on one and on two ranks, against ``torch.linalg.solve`` (rtol
   1e-8, atol 1e-9) and ``make_structured_solve`` (1e-10); c. the bench's
   first-pass and drain-round artifacts (float32, B=16384), cold start in
   fresh processes: live (import, build, first drained solve) and from the
   artifacts (import, load, install, first drained solve, no frontend
   module imported), each with a second solve; statuses equal, a second
   load of the same bytes (deserialized anew) bit for bit alike; and a float64 B=1024 artifact
   against the live solve (obj rtol 1e-12, z atol 1e-10).

11. the LOQO barrier rule, the unrolled block core and the native nodes
   (b and d after phase 10, a and c as two runs of the pool of phases 5-8):
   a. the five gates of
   ``tools/compare_mu.py`` (the LQR, the brachistochrone, the bang-bang
   double integrator, the 15x8 LGL orbit, the 3-phase Goddard), one lane
   each in float64 at tol 1e-8 under ``auto``, for each of monotone,
   adaptive and mehrotra: iterations, status, objective and launches per
   kernel (no run raises; where adaptive and monotone both converge,
   objectives within 1e-6; the adaptive LQR launches all three kernels);
   b. phase 4's bench batch under ``mu_strategy="adaptive"`` (one warm-up,
   one timed batch) beside phase 4's monotone figures, gated on phase 4's
   parity; c. the unrolled block core on the K batches of the LQR, the
   Goddard and the 40x10 orbit at a random point (each lane its own
   diagonal scaling), at B=1024 and the first 64 lanes alone, in both
   types: every lane bit for bit alike at both sizes, within 1e-9 of the
   lax core in float64, lax's own invariance printed; then the Goddard at
   B=64 in float64 on the block path with each core (phase 6's float64
   gates); d. whether the port's C++ node library loaded, its build
   seconds, and its nodes against the numpy path and ``leggauss``.

The runs of phases 5-8, 11a and 11c go four at a time, each in a process
of its own with its own launch counts: their IPM loops are bound by the
host.

``--first-pass GATE`` runs only a float32 gate's first pass (the tool's
first-pass options, no drain) on the first ``--lanes`` lanes of its
B=1024 draw, through the kernel path (on ``--device cpu``, the kernels'
plain versions) and through the block core, and prints one JSON line per
path with each lane's status and iterations: which lanes each path's
rules leave unconverged.

The line before the last lists each kernel's launches on the main path
(and per batch), its error against the plain version, both times, and
its bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak for the type (``cuda_kkt.kernel_cost``,
from this run's shapes and retries); under ``"gates"`` the same at each
of phases 5 and 6's shapes and types, with that phase's launches per
batch; under ``"sweep"`` the same at each padded shape of each of phase
7's three sweeps, with its launches in that sweep; under ``"mpc"`` its launches per cold
solve and per replan of phase 9a in each type; under ``"sharded"`` its
launches in phase 10a on one rank in each type and on each of the two
ranks, and in 10c's first drained solve from the artifacts; under
``"barrier"`` its launches in each solve of 11a and per batch of 11b. The last line is ``{"ok": true,
"device": {...}}``.
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


def retry_block(nb):
    """The block that :func:`kernel_inputs` makes indefinite on every 7th
    lane: block 3, or the last of fewer blocks."""
    return min(3, nb - 1)


def kernel_inputs(core, B, dtype, seed, device, nb=10, ni=16, nr=25, lanes=None):
    """Batch-last padded blocks (the bench shapes by default), with the
    interiors' spectra set: eigenvalues in [1, 10], except every 7th lane's
    block 3 with one eigenvalue at -0.5 (the retry ladder 0 -> 0.1 -> 1.0
    accepts it at 1.0) and every 61st lane's block 5 with one at -50
    (rejected at every rung); with fewer blocks, the last one takes either.
    Plus the apply right-hand sides. Every accepted block is well
    conditioned, so kernel and plain version differ only by rounding.
    ``lanes`` cuts the padded lanes to that count."""
    import torch

    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((B, nb, ni, ni)))
    lam = rng.uniform(1.0, 10.0, (B, nb, ni))
    lam[::7, retry_block(nb), 0] = -0.5
    lam[::61, min(5, nb - 1), 0] = -50.0
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


def phase_ragged(dtype, rtol, nb, ni, nr, attempts=3, lanes=1001, timed=False, inputs=None):
    """The three kernels against their plain versions at a ragged shape:
    ``nb`` interiors of ``ni`` and a reduced block of ``nr``, padded to
    multiples of 8, on 1001 lanes (a multiple of neither the factor's lane
    tile, 32 nor 128) unless ``lanes`` says otherwise. Each kernel takes the
    kernel outputs before it, and its plain version the same inputs. Same
    flags, levels and per-lane tolerance as the bench shapes. With
    ``timed``, returns the errors, each kernel's ms (CUDA events over a few
    launches), its plain version's ms (the compared call itself) and the
    interior Cholesky retries this data needs. ``inputs`` passes the
    ``(core, kernel inputs)`` of an earlier call at the same shape."""
    import torch

    from pockit_tpu_torch.solver import cuda_kkt as ck

    if inputs is None:
        inputs = ragged_inputs(dtype, nb, ni, nr, lanes)
    core, (Kt, b_i, b_r) = inputs
    kw = dict(ni_real=ni, nr_real=nr, pivot_rtol=2.0 * float(np.sqrt(np.finfo(np.float32).eps)),
              delta_floor=0.1, attempts=attempts)
    delta = torch.zeros(lanes, dtype=dtype, device="cuda")
    plain_ms = {}

    def plain(name, fn):
        """Run a plain version once, timed with CUDA events."""
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn()
        t1.record()
        torch.cuda.synchronize()
        plain_ms[name] = t0.elapsed_time(t1)
        return out

    fac = ck.factor_blocks(*Kt, delta, **kw)
    fac_ref = plain("factor", lambda: ck.factor_blocks_ref(*Kt, delta, **kw))
    ok = fac[5][3] > 0.5
    if not torch.equal(ok, fac_ref[5][3] > 0.5) or not torch.equal(fac[6], fac_ref[6]):
        raise AssertionError("ragged: flags or per-block levels differ from the plain version")
    retried = bool((fac[6][retry_block(nb)] > 0).any())
    if bool(ok.all()) or retried != (attempts > 1):
        raise AssertionError("ragged: the inputs did not exercise the retry ladder and rejection")
    lanes_ok = torch.nonzero(ok)[:, 0]
    # (max abs error, max per-lane relative error) over the accepted lanes
    worst = lambda got, want: tuple(np.max([max_err(a[..., lanes_ok], b[..., lanes_ok])
                                            for a, b in zip(got, want)], axis=0))
    L_i, sc_i, X_ir, L_r, sc_r, _, _ = fac
    down = ck.apply_down(L_i, sc_i, Kt[1], b_i, b_r)
    down_ref = plain("apply_down", lambda: ck.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r))
    up = ck.apply_up(L_r, sc_r, down[1], X_ir, down[0])
    up_ref = plain("apply_up", lambda: ck.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0]))
    err = {"factor": worst(fac, fac_ref), "apply_down": worst(down, down_ref),
           "apply_up": worst(up, up_ref)}
    errs = {k: v[1] for k, v in err.items()}
    launch = ck.apply_up_launch(nb, core.ni_p, core.nr_p, lanes, dtype)
    print(f"phase 2 ragged {dtype} nb={nb} ni_p={core.ni_p} nr_p={core.nr_p} lanes={lanes} "
          f"attempts={attempts} (factor lanes per CTA "
          f"{ck.factor_tile_lanes(core.ni_p, core.nr_p, dtype)}, apply_up body "
          f"{launch['body']} warps {launch['warps']}): "
          + " ".join(f"{k} max_lane_rel_err={v:.3e}" for k, v in errs.items())
          + f"; lanes accepted {int(ok.sum())} (tolerance per-lane rel {rtol:.0e})", flush=True)
    if not max(errs.values()) <= rtol:
        raise AssertionError(f"ragged {dtype}: kernel vs plain per-lane error above {rtol:.0e}")
    if not timed:
        return None
    d_int = fac[6][:-1].double()
    chol_retries = int(torch.where(
        d_int > 0, 1 + torch.round(torch.log10(d_int / kw["delta_floor"])), 0).sum())
    times = {
        "factor": (cuda_ms(lambda: ck.factor_blocks(*Kt, delta, **kw), 3), plain_ms["factor"]),
        "apply_down": (cuda_ms(lambda: ck.apply_down(L_i, sc_i, Kt[1], b_i, b_r), 10),
                       plain_ms["apply_down"]),
        "apply_up": (cuda_ms(lambda: ck.apply_up(L_r, sc_r, down[1], X_ir, down[0]), 10),
                     plain_ms["apply_up"]),
    }
    print(f"phase 2 times {dtype} nb={nb} ni_p={core.ni_p} nr_p={core.nr_p} lanes={lanes}: "
          + ", ".join(f"{k} kernel {v[0]:.3f} ms plain {v[1]:.3f} ms" for k, v in times.items()),
          flush=True)
    return {"shape": (nb, core.ni_p, core.nr_p), "lanes": lanes,
            "abs_err": {k: v[0] for k, v in err.items()}, "times": times,
            "chol_retries": chol_retries}


def ragged_inputs(dtype, nb, ni, nr, lanes):
    """The core and kernel inputs of :func:`phase_ragged` at a shape."""
    from pockit_tpu_torch.solver import cuda_kkt as ck

    core = ck.make_core(np.arange(nb * ni).reshape(nb, ni), np.arange(nb * ni, nb * ni + nr),
                        nb * ni + nr)
    return core, kernel_inputs(core, lanes, dtype, seed=11, device="cuda", nb=nb, ni=ni, nr=nr,
                               lanes=lanes)


# ---------------------------------------------------------------------------
# phases 5 and 6: the two configurations of tools/bench_gates.py, in the port
# ---------------------------------------------------------------------------

T_THRUST, MDOT, TF = 0.1405, 0.0749, 3.32
R_F_KNOWN = 1.5253
U_MAX, C_EX, D0, BETA, MF = 3.5, 0.5, 310.0, 500.0, 0.6
H_STAR = 1.012837
# padded (nb, ni_p, nr_p) of each gate, and the unpadded (nb, ni, nr) whose
# kernel inputs phase 2 draws there
GATE_SHAPES = {"orbit": ((40, 40, 128), (40, 37, 126)), "goddard": ((12, 32, 64), (12, 25, 60))}


def build_orbit(radau, mesh=40, num_point=10):
    """Max-radius orbit transfer on a 40x10 Radau mesh (tools/bench_gates.py);
    ``radau`` is the scheme's module, of either package."""
    import sympy as sp

    system = radau.System(["r_f"])
    (r_f,) = system.s
    phase = system.new_phase(["r", "u", "v"], ["phi"])
    r, u, v = phase.x
    (phi,) = phase.u
    t = phase.t
    acc = T_THRUST / (1 - MDOT * t)
    phase.set_dynamics([u, v**2 / r - 1 / r**2 + acc * sp.sin(phi),
                        -u * v / r + acc * sp.cos(phi)])
    phase.set_boundary_condition([1.0, 0.0, 1.0], [r_f, 0.0, 1 / sp.sqrt(r_f)], 0.0, TF)
    phase.set_discretization(mesh, num_point)
    system.set_phase([phase])
    system.set_objective(-r_f)
    guess = radau.linear_guess(phase, 1.0)
    guess.x[0] = 1.0 + 0.5 * phase.t_x
    guess.x[1] = 0.1
    guess.x[2] = 1.0
    guess.u[0] = 0.5
    return system, [guess, [1.5]]


def orbit_bc(compiled, B, rng):
    """fixed_vals order: x0 (r, u, v), u_f, t0, tf. Perturbed circular
    starts r0 ~ U(0.99, 1.03), v0 = 1/sqrt(r0); lane 0 nominal."""
    bc = np.tile(compiled.phases[0].fixed_vals, (B, 1))
    r0 = rng.uniform(0.99, 1.03, B)
    r0[0] = 1.0
    bc[:, 0] = r0
    bc[:, 2] = 1.0 / np.sqrt(r0)
    return (bc,)


def build_goddard(radau):
    """Three-phase Goddard rocket, 4x7 Radau per phase (tools/bench_gates.py)."""
    import sympy as sp

    system = radau.System(["t_a", "t_b", "t_f", "h_a", "v_a", "m_a", "h_b", "v_b", "h_f"])
    t_a, t_b, t_f, h_a, v_a, m_a, h_b, v_b, h_f = system.s

    def make_phase(u_lb, u_ub, bc0, bcf, t0, t1):
        ph = system.new_phase(["h", "v", "m"], ["u"])
        h, v, m = ph.x
        (u,) = ph.u
        drag = D0 * v**2 * sp.exp(-BETA * (h - 1))
        ph.set_dynamics([v, (u - drag) / m - 1 / h**2, -u / C_EX])
        ph.set_phase_constraint([u], [u_lb], [u_ub])
        ph.set_boundary_condition(bc0, bcf, t0, t1)
        ph.set_discretization(4, 7)
        return ph

    p1 = make_phase(U_MAX, U_MAX, [1.0, 0.0, 1.0], [h_a, v_a, m_a], 0.0, t_a)
    p2 = make_phase(0.0, U_MAX, [h_a, v_a, m_a], [h_b, v_b, MF], t_a, t_b)
    p3 = make_phase(0.0, 0.0, [h_b, v_b, MF], [h_f, 0.0, MF], t_b, t_f)
    system.set_phase([p1, p2, p3])
    system.set_objective(-h_f)
    guesses = []
    for ph, (h0, h1), (vv0, vv1), (mm0, mm1), uu in [
        (p1, (1.0, 1.005), (0.0, 0.1), (1.0, 0.8), U_MAX),
        (p2, (1.005, 1.01), (0.1, 0.05), (0.8, MF), 1.0),
        (p3, (1.01, 1.013), (0.05, 0.0), (MF, MF), 0.0),
    ]:
        g = radau.linear_guess(ph, 0.5)
        g.x[0] = h0 + (h1 - h0) * ph.t_x
        g.x[1] = vv0 + (vv1 - vv0) * ph.t_x
        g.x[2] = mm0 + (mm1 - mm0) * ph.t_x
        g.u[0] = uu
        guesses.append(g)
    statics = [0.023, 0.068, 0.2, 1.005, 0.1, 0.8, 1.01, 0.05, 1.0128]
    return system, guesses + [statics]


def goddard_bc(compiled, B, rng):
    """Phase 1's fixed_vals: the BC slots [h0, v0, m0, t0], then its pinned
    control slots (pinned lb == ub variables follow the BC slots). Launch
    mass m0 ~ U(0.97, 1.03) (slot 2); lane 0 nominal; phases 2 and 3 as
    configured."""
    bcs = []
    for i, cp in enumerate(compiled.phases):
        bc = np.tile(cp.fixed_vals, (B, 1))
        if i == 0:
            m0 = rng.uniform(0.97, 1.03, B)
            m0[0] = 1.0
            bc[:, 2] = m0
        bcs.append(bc)
    return tuple(bcs)


# name: the problem's constructor, its draw, the objective's name and its
# published optimum, the float32 options of tools/bench_gates.py (tol,
# mu_strategy, delta_w_min), and the JAX package's float32 gate tolerance on
# the objective
GATES = {
    "orbit": (build_orbit, orbit_bc, "r_f", R_F_KNOWN, (1e-5, "monotone", 3e-3), 5e-3),
    "goddard": (build_goddard, goddard_bc, "h_f", H_STAR, (5e-5, "mehrotra", 1e-1), 1e-3),
}


def pinned_control_error(radau, system, z0):
    """Lane 0's largest distance of Goddard's pinned controls from their
    pins (full thrust in phase 1, none in phase 3), after the boundary
    values are substituted back."""
    from pockit_tpu_torch.optimizer._common import postprocess

    value = postprocess(radau.Variable, system, z0, False)
    return max(float(np.max(np.abs(value[0].u[0] - U_MAX))), float(np.max(np.abs(value[2].u[0]))))


def gate_run(name, run, B, device="cuda", block_core="auto", phase=None):
    """One run of a configuration of tools/bench_gates.py through the
    port's ``solve_batch_drained`` on ``B`` lanes (drain rounds of B/8
    stragglers, as the tool): ``run`` is "f64" or "f32" through the kernels
    (on the CPU, their plain versions) or "f64_block" / "f32_block" through
    the plain block core of ``block_core``. Raises on a failed gate;
    returns the run's figures, printed as ``phase <phase>`` (by default 5
    for the orbit, 6 for Goddard)."""
    import dataclasses

    import torch

    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver import IPOptions
    from pockit_tpu_torch.solver import cuda_kkt

    build, draw, obj_name, obj_star, (tol32, mu32, dwmin32), tol_obj32 = GATES[name]
    system, guess = build(radau)
    x0, _ = preprocess(system, guess)
    bc = draw(system.compiled, B, np.random.default_rng(0))
    padded = GATE_SHAPES[name][0]
    on_card = torch.device(device).type == "cuda"
    dtype = torch.float64 if run.startswith("f64") else torch.float32
    if dtype == torch.float64:
        fast = IPOptions(tol=1e-7, max_iter=60, refine_steps=3)
    else:
        fast = IPOptions(tol=tol32, max_iter=60, refine_steps=3, mu_strategy=mu32,
                         delta_w_min=dwmin32)
    kkt = "block" if run.endswith("_block") else ("auto" if on_card else "pallas")
    fast = dataclasses.replace(fast, kkt_solver=kkt, block_core=block_core)
    drain = dataclasses.replace(fast, max_iter=120)
    z0 = torch.as_tensor(np.tile(x0, (B, 1)), dtype=dtype, device=device)
    bc_t = tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in bc)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cuda_kkt.reset_launches()
    t0 = time.perf_counter()
    status, obj, iters, z, first = ipm.solve_batch_drained(
        system, z0, bc_overrides=bc_t, optimizer_options=drain, first_pass_options=fast,
        return_first_pass_mask=True)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kkt.LAUNCHES)
    shapes = {k: sorted(v) for k, v in cuda_kkt.LAUNCH_SHAPES.items()}
    z_np = z.double().cpu().numpy()
    rec = dict(
        gate=name, run=run, batch=B, kkt_solver=kkt, block_core=block_core, tol=fast.tol,
        mu_strategy=fast.mu_strategy, delta_w_min=fast.delta_w_min,
        converged_frac=float(np.mean(status == 0)), first_pass_frac=float(np.mean(first)),
        mean_iters=float(np.mean(iters)), lane0_status=int(status[0]),
        lane0_objective=float(-obj[0]), parity_err_lane0=abs(float(-obj[0]) - obj_star),
        wall_s_per_batch=wall, solves_per_s=B / wall, launches=launches,
        launch_shapes=shapes, finite=bool(np.isfinite(z_np).all() & np.isfinite(obj).all()),
        max_memory_allocated=int(torch.cuda.max_memory_allocated()) if on_card else None,
    )
    if name == "goddard":
        rec["lane0_pinned_err"] = pinned_control_error(radau, system, z_np[0])
    phase = phase or (5 if name == "orbit" else 6)
    print(f"phase {phase} {name} {run}: " + json.dumps(rec), flush=True)
    if not rec["finite"]:
        raise AssertionError(f"{name} {run}: non-finite results")
    if kkt != "block" and (min(launches.values()) == 0
                           or any(shapes[k] != [padded] for k in shapes)):
        raise AssertionError(f"{name} {run}: the kernels did not all launch at {padded}: "
                             f"{launches} {shapes}")
    tol_obj = {"orbit": 5e-3, "goddard": 1e-3}[name] if dtype == torch.float64 else tol_obj32
    if rec["parity_err_lane0"] > tol_obj:
        raise AssertionError(f"{name} {run}: lane 0 {obj_name} {rec['lane0_objective']} is "
                             f"more than {tol_obj} from {obj_star}")
    if name == "goddard" and rec["lane0_pinned_err"] > 1e-6:
        raise AssertionError(f"{name} {run}: pinned controls off by {rec['lane0_pinned_err']}")
    if dtype == torch.float64 and rec["converged_frac"] < 0.99:
        raise AssertionError(f"{name} {run}: converged_frac {rec['converged_frac']} < 0.99")
    return rec


def first_pass(name, lanes, device):
    """``--first-pass``: the float32 first pass of gate ``name`` on lanes
    0..lanes-1 of its B=1024 draw, through the kernel path and the block
    core; prints and returns each path's per-lane status and iterations."""
    import torch

    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver import IPOptions

    build, draw, _, _, (tol32, mu32, dwmin32), _ = GATES[name]
    system, guess = build(radau)
    x0, _ = preprocess(system, guess)
    bc = tuple(v[:lanes] for v in draw(system.compiled, 1024, np.random.default_rng(0)))
    kernels = "auto" if torch.device(device).type == "cuda" else "pallas"
    out = {}
    for kkt in (kernels, "block"):
        opts = IPOptions(tol=tol32, max_iter=60, refine_steps=3, mu_strategy=mu32,
                         delta_w_min=dwmin32, kkt_solver=kkt)
        z0 = torch.as_tensor(np.tile(x0, (lanes, 1)), dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        res = ipm.solve_batch(system, z0, optimizer_options=opts, bc_overrides=tuple(
            torch.as_tensor(v, dtype=torch.float32, device=device) for v in bc))
        status = res.status.cpu().numpy()
        iters = res.iterations.cpu().numpy()
        out[kkt] = rec = dict(
            gate=name, kkt_solver=kkt, device=device, lanes=lanes,
            converged_frac=float(np.mean(status == 0)), mean_iters=float(np.mean(iters)),
            unconverged=np.nonzero(status != 0)[0].tolist(), status=status.tolist(),
            iters=iters.tolist(), seconds=time.perf_counter() - t0,
        )
        print(f"first pass {name} {kkt}: " + json.dumps(rec), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: the refine sweep; phase 8: a shape the kernels do not take
# ---------------------------------------------------------------------------

SWEEP_B = 4096
BANG_BANG_B = 32
BANG_BANG_KW = dict(
    max_refine_rounds=4,
    check_kw=dict(tolerance_discontinuous=1e-3, absolute_tolerance_continuous=1e-5,
                  relative_tolerance_continuous=1e-5),
)


def build_cubic(radau, x0):
    """``tools/bench_refine_sweep.py``'s sweep: x' = -x^3 + u, minimize the
    integral of x^2 + u^2 on a coarse 2x4 Radau mesh (it fails the check
    and p-refines), with x(0) per instance. Returns ``(system, guess,
    bc_overrides)``."""
    system = radau.System(0)
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([-(x**3) + u])
    phase.set_integral([x**2 + u**2])
    phase.set_boundary_condition([1.0], [None], 0.0, 1.0)
    phase.set_discretization(2, 4)
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    c = system.compiled
    bc = np.tile(np.asarray(c.phases[0].fixed_vals), (len(x0), 1))
    bc[:, list(np.asarray(c.phases[0].fixed_idx)).index(int(phase.l_v[0]))] = x0
    return system, radau.linear_guess(phase, 0.5), (bc,)


def build_bang_bang(radau, v0):
    """``tests/test_parallel/test_refine_batch.py``'s minimum-time double
    integrator, the initial velocity per instance (``v0=None``: the
    configured 0). Its optimum is T* = 2 vp - v0, vp = sqrt(1 + v0^2 / 2),
    with the switch at the scaled time (vp - v0) / T*. Returns ``(system,
    guess, bc_overrides)``."""
    system = radau.System(0)
    phase = system.new_phase(["x", "v"], ["u"])
    x, v = phase.x
    (u,) = phase.u
    t = phase.t
    phase.set_dynamics([v, u])
    phase.set_integral([1])
    phase.set_phase_constraint([u, t], [-1.0, 0.5], [1.0, 6.0], bang_bang_control=[True, False])
    phase.set_boundary_condition([0.0, 0.0], [1.0, 0.0], 0.0, None)
    phase.set_discretization(3, 6)
    system.set_phase([phase])
    system.set_objective(phase.I[0])
    guess = radau.linear_guess(phase, 0.5)
    guess.t_f = 3.0
    if v0 is None:
        return system, guess, None
    c = system.compiled
    bc = np.tile(np.asarray(c.phases[0].fixed_vals), (len(v0), 1))
    bc[:, list(np.asarray(c.phases[0].fixed_idx)).index(int(phase.l_v[1]))] = v0
    return system, guess, (bc,)


def sweep_run(run, device="cuda"):
    """Phase 7: ``run`` "f32" / "f64" is ``tools/bench_refine_sweep.py``'s
    sweep (B=4096, x0 ~ U(0.5, 1.5) from ``default_rng(5)``, 2 rounds,
    check and plan tolerance 1e-5 / 1e-8) with ``auto`` on the card;
    "bang_bang" is the reference test's double integrator at B=32 in
    float64, held against its analytic optimum (5e-4), every instance
    passed, more than one bucket. The split of the wall comes from the
    sweep's bucket records (solves and error statistics, each ending with
    its copy to the host; the rest is host work: adapt, plan, bucket and
    write back). Raises on a failed check; returns the run's figures, with
    ``shapes``: per padded block-arrow shape its unpadded shape, buckets,
    largest bucket's lanes and kernel launches (the kernels are held
    against their plain versions there by :func:`sweep_kernels`)."""
    import torch

    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.parallel import solve_refine_batch
    from pockit_tpu_torch.solver import cuda_kkt

    on_card = torch.device(device).type == "cuda"
    if run == "bang_bang":
        dtype, B = torch.float64, BANG_BANG_B
        v0 = np.random.default_rng(5).uniform(-0.5, 0.5, B)
        system, guess, bc = build_bang_bang(radau, v0)
        kw = BANG_BANG_KW
    else:
        dtype = torch.float32 if run == "f32" else torch.float64
        B = SWEEP_B if on_card else 64
        tol = 1e-5 if run == "f32" else 1e-8
        system, guess, bc = build_cubic(radau, np.random.default_rng(5).uniform(0.5, 1.5, B))
        tols = dict(absolute_tolerance_continuous=tol, relative_tolerance_continuous=tol)
        kw = dict(max_refine_rounds=2, check_kw=tols, refine_kw=tols)
    cuda_kkt.reset_launches()
    t0 = time.perf_counter()
    res = solve_refine_batch(system, guess, bc_overrides=bc, device=device, dtype=dtype, **kw)
    wall = time.perf_counter() - t0
    launches = dict(cuda_kkt.LAUNCHES)
    solve_s = sum(b["solve_s"] for b in res.buckets)
    stats_s = sum(b["stats_s"] for b in res.buckets)
    shapes = {}
    for b in res.buckets:
        nb, ni, nr = b["block_shape"]
        padded = (nb, cuda_kkt._ceil_to(ni, 8), cuda_kkt._ceil_to(nr, 8))
        rec = shapes.setdefault(padded, dict(shape=[nb, ni, nr], lanes=0, buckets=0, launches={
            k: cuda_kkt.LAUNCH_SHAPES[k][padded] for k in launches}))
        rec["lanes"] = max(rec["lanes"], b["lanes"])
        rec["buckets"] += 1
    rec = dict(
        run=run, batch=B, dtype=str(dtype).replace("torch.", ""), wall_s=wall,
        solve_s=solve_s, stats_s=stats_s, host_s=wall - solve_s - stats_s,
        host_share=(wall - solve_s - stats_s) / wall,
        bucket_solves=res.n_bucket_solves, rounds_used=res.rounds_used,
        converged_frac=float(np.mean(res.status == 0)), passed_frac=float(np.mean(res.passed)),
        launches=launches, paths=sorted({b["kkt_solver"] for b in res.buckets}),
        shapes={str(list(k)): v for k, v in sorted(shapes.items())},
        finite=bool(np.isfinite(res.obj).all()),
    )
    print(f"phase 7 sweep {run}: " + json.dumps(rec), flush=True)
    if not rec["finite"]:
        raise AssertionError(f"sweep {run}: non-finite objectives")
    if on_card and (rec["paths"] != ["pallas"] or min(launches.values()) == 0):
        raise AssertionError(f"sweep {run}: auto did not take the kernels at every bucket: "
                             f"{rec['paths']} {launches}")
    if run == "bang_bang":
        vp = np.sqrt(1.0 + v0**2 / 2)
        err = float(np.max(np.abs(res.obj - (2 * vp - v0))))
        rec["max_err_T_star"] = err
        print(f"phase 7 bang-bang B={B}: max |T - T*| {err:.3e} (tolerance 5e-4), "
              f"passed {rec['passed_frac']}, buckets {res.n_bucket_solves}", flush=True)
        if not (res.status == 0).all() or not res.passed.all() or err > 5e-4 \
                or res.n_bucket_solves <= 1:
            raise AssertionError("bang-bang sweep: not every instance passed at T*")
    if run == "f64" and min(rec["converged_frac"], rec["passed_frac"]) < 0.99:
        raise AssertionError(f"sweep f64: converged {rec['converged_frac']} passed "
                             f"{rec['passed_frac']}, below 0.99")
    return rec


def sweep_kernels(sweeps):
    """The kernels against their plain versions, timed, at every padded
    shape each phase-7 sweep took (its unpadded shape, the largest bucket's
    lanes, one attempt as the sweep's solves; per-lane tolerance 1e-4 in
    float32, 1e-11 in float64), one shape after another in this process
    once the pool has drained, as phase 2 times the gate shapes. Adds
    ``kernels``, ``{padded: figures}``, to each sweep's record."""
    import torch

    for run, rec in sweeps.items():
        dtype = torch.float32 if run == "f32" else torch.float64
        tol = 1e-4 if dtype == torch.float32 else 1e-11
        rec["kernels"] = {}
        for padded, shp in rec["shapes"].items():
            nb, ni, nr = shp["shape"]
            got = phase_ragged(dtype, tol, nb, ni, nr, attempts=1, lanes=shp["lanes"], timed=True)
            got["launches_per_sweep"] = shp["launches"]
            rec["kernels"][padded] = got


def f1_run(device="cuda"):
    """Phase 8: the 42x10 Radau orbit, whose reduced block (132) pads past
    the kernels' 128, at B=64 in float64 under ``auto``: the chooser says
    "block", the solve launches no kernel and its lanes are finite; explicit
    ``"pallas"`` on that shape raises before any launch. Then the chooser
    says "pallas" for the padded shapes of phases 4-6 in both types.
    Returns the figures."""
    import torch

    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.examples.lqr import build as lqr_build
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver import IPOptions, cuda_kkt
    from pockit_tpu_torch.solver.structured import structured_layout

    B, f64 = 64, torch.float64
    system, guess = build_orbit(radau, 42)
    layout = structured_layout(system)
    chosen = cuda_kkt.kernel_path(layout.interior, layout.reduced, f64, device)
    x0, _ = preprocess(system, guess)
    bc = tuple(torch.as_tensor(v, dtype=f64, device=device)
               for v in orbit_bc(system.compiled, B, np.random.default_rng(0)))
    z0 = torch.as_tensor(np.tile(x0, (B, 1)), dtype=f64, device=device)
    opts = IPOptions(tol=1e-7, max_iter=60, refine_steps=3)
    cuda_kkt.reset_launches()
    t0 = time.perf_counter()
    res = ipm.solve_batch(system, z0, bc_overrides=bc, optimizer_options=opts)
    wall = time.perf_counter() - t0
    launches = dict(cuda_kkt.LAUNCHES)
    refused = None
    try:
        ipm.solve_batch(system, z0, bc_overrides=bc,
                        optimizer_options=IPOptions(tol=1e-7, max_iter=60, kkt_solver="pallas"))
    except ValueError as e:
        refused = str(e)
    status = res.status.cpu().numpy()
    r_f = float(res.z[0, system.l_s].item())
    others = {}
    for name, (sys_k, _) in {"phase 4 lqr": lqr_build(),
                             "phase 5 orbit": build_orbit(radau),
                             "phase 6 goddard": build_goddard(radau)}.items():
        lay = structured_layout(sys_k)
        for dt in (torch.float32, torch.float64):
            others[f"{name} {str(dt).replace('torch.', '')}"] = cuda_kkt.kernel_path(
                lay.interior, lay.reduced, dt, device)
    rec = dict(
        mesh="42x10 Radau", reduced=len(layout.reduced), interior=int(layout.interior.shape[1]),
        batch=B, chosen=chosen, launches=launches, launches_after_pallas=dict(cuda_kkt.LAUNCHES),
        pallas_refused=refused, converged_frac=float(np.mean(status == 0)),
        mean_iters=float(res.iterations.float().mean()), lane0_r_f=r_f,
        finite=bool(torch.isfinite(res.z).all()), wall_s=wall, chooser_at_earlier_phases=others,
    )
    print("phase 8 F1: " + json.dumps(rec), flush=True)
    if torch.device(device).type == "cuda":
        if chosen != "block" or max(launches.values()) or refused is None \
                or max(cuda_kkt.LAUNCHES.values()):
            raise AssertionError("phase 8: auto or the explicit kernel path did not refuse the "
                                 "42x10 orbit's shape before any launch")
        if set(others.values()) != {"pallas"}:
            raise AssertionError(f"phase 8: the chooser refused an earlier phase's shape: {others}")
    if not rec["finite"]:
        raise AssertionError("phase 8: non-finite lanes")
    return rec


# every run of phases 5 to 8, the longest first (an H100 with its host: the
# orbit's float64 run is bound by its factor, the rest by the host)
POOL_RUNS = (("gate", "orbit", "f64"), ("sweep", "bang_bang"), ("gate", "goddard", "f32_block"),
             ("gate", "goddard", "f32"), ("gate", "orbit", "f32"), ("sweep", "f64"),
             ("sweep", "f32"), ("f1",), ("gate", "orbit", "f32_block"), ("gate", "goddard", "f64"),
             ("mu",), ("unrolled",))


def _pool_init():
    import torch

    torch.set_num_threads(2)  # the runs share the host's cores


def _pool_run(key, B, device):
    kind, args = key[0], key[1:]
    if kind == "gate":
        return gate_run(*args, B, device)
    if kind == "sweep":
        return sweep_run(*args, device)
    if kind == "mu":
        return mu_run(device)
    if kind == "unrolled":
        return unrolled_run(device)
    return f1_run(device)


def phase_pool(B, device="cuda", workers=4):
    """Phases 5 to 8 and 11a, 11c: every run of :data:`POOL_RUNS`, ``workers`` at a time,
    each in a process of its own (spawned; the IPM loops are bound by the
    host, so runs side by side share the card and use more of the host's
    cores); each run resets and reads its own kernel launch counts. Then
    the float32 kernels against the block core of each gate. Raises on a
    failed run (after the runs in flight end; the pool's processes are
    stopped); returns the gates', the sweeps', F1's and phase 11's figures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_pool_init) as pool:
        futures = {key: pool.submit(_pool_run, key, B, device) for key in POOL_RUNS}
        try:
            done = {key: f.result() for key, f in futures.items()}
        except BaseException:
            for f in futures.values():
                f.cancel()
            raise
    gates = {}
    for key, rec in done.items():
        if key[0] == "gate":
            gates.setdefault(key[1], {})[key[2]] = rec
    for gate, runs in gates.items():
        gap = runs["f32"]["converged_frac"] - runs["f32_block"]["converged_frac"]
        print(f"phase {5 if gate == 'orbit' else 6} {gate} float32 kernels against block core: "
              f"converged {runs['f32']['converged_frac']:.4f} against "
              f"{runs['f32_block']['converged_frac']:.4f} (gap {gap:+.4f})", flush=True)
        if gap < -0.01:
            raise AssertionError(f"{gate} f32: the kernels converged fewer lanes than the block "
                                 f"core by more than 1%")
    return (gates, {key[1]: rec for key, rec in done.items() if key[0] == "sweep"}, done[("f1",)],
            {"mu": done[("mu",)], "unrolled": done[("unrolled",)]})


# ---------------------------------------------------------------------------
# phase 9: continuation and MPC (BASELINE config 5), the IPOPT shim, the scipy
# adapter and the ops hooks, on the LQR 10x10 LGL through the kernels
# ---------------------------------------------------------------------------

MPC_B = 8192
LIVE_B = 256
LQR_PADDED = (10, 16, 32)


class Killed(RuntimeError):
    """Raised by an ``on_stage`` callback to kill a sweep after a stage."""


def lqr_launches(what):
    """This run's kernel launches; raises unless all three launched, and only
    at the LQR's padded shape."""
    from pockit_tpu_torch.solver import cuda_kkt

    launches = dict(cuda_kkt.LAUNCHES)
    shapes = {k: sorted(v) for k, v in cuda_kkt.LAUNCH_SHAPES.items()}
    if min(launches.values()) == 0 or any(v != [LQR_PADDED] for v in shapes.values()):
        raise AssertionError(f"phase 9 {what}: the kernels did not all launch at {LQR_PADDED}: "
                             f"{launches} {shapes}")
    return launches


def lqr_problem():
    """The example's LQR (``pockit_tpu_torch.examples.lqr``) and its flat
    constant guess."""
    from pockit_tpu_torch.examples.lqr import build
    from pockit_tpu_torch.lobatto import constant_guess
    from pockit_tpu_torch.optimizer._common import preprocess

    system, phase = build()
    guess = [constant_guess(phase, 0), [0.0]]
    return system, guess, preprocess(system, guess)[0]


def mpc_run(dtype, B=MPC_B, device="cuda"):
    """9a: ``examples/mpc_sweep.py`` at B lanes (x(0) ~ U(0.5, 1.5) from
    ``default_rng(0)``, the replan's drift N(0, 0.02)): a cold
    ``solve_batch`` from the constant guess, then one warm replan from the
    cold ``res.z`` on the device, at the example's options for ``dtype``.
    Gated in float64 (converged >= 0.99, each converged lane's objective
    within 1e-6 relative of J1 x0^2); float32 is reported. Returns the
    figures and a function that runs the replan again."""
    import torch

    from pockit_tpu_torch.examples import mpc_sweep
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import cuda_kkt

    system, _, x0 = lqr_problem()
    bc, bc2 = mpc_sweep.draws(system.compiled.phases[0].fixed_vals, B)
    opts = mpc_sweep.options(dtype)
    t = lambda a: torch.as_tensor(a, device=device, dtype=dtype)
    z, runs = t(np.tile(x0, (B, 1))), {}
    torch.cuda.reset_peak_memory_stats()
    for run, b in (("cold", bc), ("replan", bc2)):
        cuda_kkt.reset_launches()
        t0 = time.perf_counter()
        res = ipm.solve_batch(system, z, bc_overrides=(t(b),), optimizer_options=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        status = res.status.cpu().numpy()
        want = J1 * b[:, 0] ** 2
        rel = np.abs(res.obj.double().cpu().numpy() - want) / want
        ok = status == 0
        runs[run] = dict(wall_s=wall, converged_frac=float(ok.mean()),
                         mean_iters=float(res.iterations.double().mean()),
                         max_rel_obj_err_converged=float(rel[ok].max(initial=0.0)),
                         finite=bool(torch.isfinite(res.z).all()),
                         launches=lqr_launches(f"mpc {run}"))
        if run == "cold":
            z_cold = z = res.z
    name = str(dtype).replace("torch.", "")
    rec = dict(dtype=name, batch=B, options="IPOptions(tol=2e-5, max_iter=60)" if opts else
               "defaults (tol 1e-8)", cold=runs["cold"], replan=runs["replan"],
               replans_per_s=B / runs["replan"]["wall_s"],
               max_memory_allocated=int(torch.cuda.max_memory_allocated()))
    print(f"phase 9a mpc {name}: " + json.dumps(rec), flush=True)
    for run, r in runs.items():
        if not r["finite"]:
            raise AssertionError(f"mpc {name} {run}: non-finite solutions")
        if dtype == torch.float64 and (r["converged_frac"] < 0.99
                                       or r["max_rel_obj_err_converged"] > 1e-6):
            raise AssertionError(f"mpc float64 {run}: converged {r['converged_frac']}, "
                                 f"objective error {r['max_rel_obj_err_converged']:.3e}")
    replan = lambda: ipm.solve_batch(system, z_cold, bc_overrides=(t(bc2),),
                                     optimizer_options=opts)
    return rec, replan


def homotopy_run(B=MPC_B, device="cuda"):
    """9b: ``homotopy_sweep`` at B lanes in float64, four stages ramping x(0)
    from 1 to targets ~ U(3, 6) (``default_rng(1)``) as the JAX package's
    test fixture, with a checkpoint directory: an uninterrupted sweep, one
    killed after stage 1, and a plain re-run that must solve only stages 2
    and 3. Gates: every stage's lanes converged, final objectives within 1e-6
    relative of J1 target^2 and the resumed sweep's within 1e-9 of the
    uninterrupted sweep's. Each stage's wall (solve and commit) and mean
    iterations; each stage's checkpoint seconds: its commit (host copies and
    writes, the warm batch included) timed again into another directory."""
    import tempfile

    import torch

    from pockit_tpu_torch.parallel import homotopy, homotopy_sweep
    from pockit_tpu_torch.solver import cuda_kkt

    system, _, x0 = lqr_problem()
    targets = np.random.default_rng(1).uniform(3.0, 6.0, B)
    base = np.tile(system.compiled.phases[0].fixed_vals, (B, 1))
    stages = []
    for lam in np.linspace(0.25, 1.0, 4):
        bc = base.copy()
        bc[:, 0] = 1.0 + lam * (targets - 1.0)
        stages.append((bc,))
    guess = np.tile(x0, (B, 1))
    kw = dict(device=device, dtype=torch.float64)
    marks = []
    stage_marks = lambda k, res: marks.append((time.perf_counter(),
                                               float(res.iterations.double().mean())))
    with tempfile.TemporaryDirectory() as tmp:
        cuda_kkt.reset_launches()
        t0 = time.perf_counter()
        full = homotopy_sweep(system, guess, stages, on_stage=stage_marks,
                              checkpoint_path=f"{tmp}/full", **kw)
        wall = time.perf_counter() - t0
        launches = lqr_launches("homotopy")
        commit_s, digest = [], homotopy._sweep_digest(guess, stages)
        for k, res in enumerate(full):
            t1 = time.perf_counter()
            homotopy._commit_stage(tmp, digest, k, res, k)
            commit_s.append(time.perf_counter() - t1)

        def die_after_1(k, res):
            if k == 1:
                raise Killed

        try:
            homotopy_sweep(system, guess, stages, on_stage=die_after_1,
                           checkpoint_path=f"{tmp}/killed", **kw)
        except Killed:
            pass
        else:
            raise AssertionError("homotopy: the killed sweep ran to its end")
        solved = []
        t1 = time.perf_counter()
        resumed = homotopy_sweep(system, guess, stages,
                                 on_stage=lambda k, res: solved.append(k),
                                 checkpoint_path=f"{tmp}/killed", **kw)
        resume_wall = time.perf_counter() - t1
    starts = [t0] + [m[0] for m in marks[:-1]]
    per_stage = [dict(stage=k, wall_s=t_k - t_s, mean_iters=it, checkpoint_s=c)
                 for k, ((t_k, it), t_s, c) in enumerate(zip(marks, starts, commit_s))]
    obj = full[-1].obj.cpu().numpy()
    obj_resumed = resumed[-1].obj.cpu().numpy()
    rel = float(np.max(np.abs(obj - J1 * targets**2) / (J1 * targets**2)))
    rel_resumed = float(np.max(np.abs(obj_resumed - obj) / obj))
    statuses = [int((r.status != 0).sum()) for r in full]
    rec = dict(batch=B, dtype="float64", stages=per_stage, wall_s=wall, stages_per_s=4 / wall,
               unconverged_per_stage=statuses, max_rel_obj_err=rel, resumed_solved=solved,
               resume_wall_s=resume_wall, max_rel_err_resumed_vs_uninterrupted=rel_resumed,
               launches=launches)
    print("phase 9b homotopy: " + json.dumps(rec), flush=True)
    if max(statuses) or int((resumed[-1].status != 0).sum()) or solved != [2, 3] \
            or rel > 1e-6 or rel_resumed > 1e-9:
        raise AssertionError("homotopy: a gate failed (every lane status 0, resumed stages "
                             "[2, 3], objectives within 1e-6 of J1 target^2 and 1e-9 of the "
                             "uninterrupted sweep)")
    return rec


def adapters_run(device="cuda"):
    """9c-9d: the IPOPT shim (one float64 LQR solve through the kernels,
    then ``mu_strategy="adaptive"``, which must take Mehrotra) and the scipy
    adapter (``trust-constr`` over the dense callbacks on the card),
    objectives within 1e-6 of J1."""
    import torch

    from pockit_tpu_torch.optimizer import ipopt, scipy
    from pockit_tpu_torch.solver import cuda_kkt

    system, guess, _ = lqr_problem()
    kw = dict(device=device, dtype=torch.float64)
    cuda_kkt.reset_launches()
    t0 = time.perf_counter()
    _, info = ipopt.solve(system, guess, {"tol": 1e-8, "max_iter": 80, "print_level": 0,
                                          "sb": "yes"}, **kw)
    wall = time.perf_counter() - t0
    launches = lqr_launches("ipopt")
    _, info_ad = ipopt.solve(system, guess, {"mu_strategy": "adaptive"}, **kw)
    strategies = sorted(o.mu_strategy for o in system.compiled._ipm_cache)
    rec = dict(obj=info["obj_val"], err=abs(info["obj_val"] - J1), kkt_solver=info["kkt_solver"],
               iterations=info["iterations"], wall_s=wall, launches=launches,
               adaptive=dict(obj=info_ad["obj_val"], err=abs(info_ad["obj_val"] - J1),
                             kkt_solver=info_ad["kkt_solver"], iterations=info_ad["iterations"],
                             solvers_built=strategies))
    print("phase 9c ipopt shim: " + json.dumps(rec), flush=True)
    if rec["err"] > 1e-6 or rec["kkt_solver"] != "pallas" or rec["adaptive"]["err"] > 1e-6 \
            or info_ad["kkt_solver"] != "pallas" or strategies != ["mehrotra", "monotone"]:
        raise AssertionError("ipopt shim: objective off J1, a path other than the kernels, or "
                             "'adaptive' did not take Mehrotra")
    system, guess, _ = lqr_problem()
    t0 = time.perf_counter()
    _, res = scipy.solve(system, guess, {"maxiter": 500, "gtol": 1e-10}, device=device)
    wall = time.perf_counter() - t0
    rec_sp = dict(fun=float(res.fun), err=abs(float(res.fun) - J1), status=int(res.status),
                  nit=int(res.nit), wall_s=wall)
    print("phase 9d scipy adapter: " + json.dumps(rec_sp), flush=True)
    if rec_sp["err"] > 1e-6:
        raise AssertionError(f"scipy adapter: objective {res.fun} more than 1e-6 off J1")
    return rec, rec_sp


def live_run(device="cuda"):
    """9e: ``live_metrics`` on a B=256 float32 solve at the example's options:
    the captured stdout must hold one ``[ipm]`` line per IPM trip, the
    batched aggregate, with ``it~`` counting the trips."""
    import contextlib
    import dataclasses
    import io

    import torch

    from pockit_tpu_torch.examples import mpc_sweep
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import cuda_kkt

    system, _, x0 = lqr_problem()
    bc, _ = mpc_sweep.draws(system.compiled.phases[0].fixed_vals, LIVE_B)
    opts = dataclasses.replace(mpc_sweep.options(torch.float32), live_metrics=True)
    t = lambda a: torch.as_tensor(a, device=device, dtype=torch.float32)
    out = io.StringIO()
    cuda_kkt.reset_launches()
    with contextlib.redirect_stdout(out):
        res = ipm.solve_batch(system, t(np.tile(x0, (LIVE_B, 1))), bc_overrides=(t(bc),),
                              optimizer_options=opts)
    launches = lqr_launches("live_metrics")
    lines = out.getvalue().splitlines()
    its = [int(line.split("it~")[1].split()[0]) if line.startswith("[ipm] it~") else -1
           for line in lines]
    top = int(res.iterations.max())
    rec = dict(batch=LIVE_B, lines=len(lines), max_iterations=top,
               converged_frac=float((res.status == 0).double().mean()), launches=launches,
               first=lines[:1], last=lines[-1:])
    print("phase 9e live_metrics: " + json.dumps(rec), flush=True)
    if its != list(range(len(lines))) or not top <= len(lines) <= top + 1:
        raise AssertionError("live_metrics: not one [ipm] line per IPM trip")
    return rec


def device_busy(trace_path):
    """The device's work in a ``profile_trace`` file: the union of its
    kernel, copy and set intervals (busy seconds), the kernels' summed
    seconds, the port's three kernels' seconds and launches, and the five
    kernels that take most of the time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy_us, end = 0.0, -np.inf
    for start, stop, _, _ in dev:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name, ours = {}, {}
    for start, stop, name, cat in dev:
        if cat == "kernel":
            by_name[name] = by_name.get(name, 0.0) + (stop - start)
            for k in ("factor", "apply_down", "apply_up"):
                if f"{k}_kernel" in name:
                    s, n = ours.get(k, (0.0, 0))
                    ours[k] = (s + (stop - start) / 1e6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(device_events=len(dev), kernels=sum(1 for d in dev if d[3] == "kernel"),
                kernel_s=sum(by_name.values()) / 1e6, busy_s=busy_us / 1e6,
                port_kernels={k: {"s": v[0], "launches": v[1]} for k, v in ours.items()},
                top_kernels=[[name[:80], us / 1e6] for name, us in top])


def profile_run(replan):
    """9f: one warm replan of 9a timed alone, then again under
    ``profile_trace``: the device's busy seconds (kernels, copies, sets;
    the same work either way) over each wall. The profiler's host cost
    stretches its own wall, so the unprofiled wall gives the replan's busy
    share. Printed, not gated; with no device event in the trace, "not
    measured"."""
    import tempfile

    import torch

    from pockit_tpu_torch.utils import profile_trace

    t0 = time.perf_counter()
    replan()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile_trace(tmp) as prof:
            replan()
            torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
        rec = dict(wall_s=wall, profiled_wall_s=wall_prof, **device_busy(prof.trace_path))
    if rec["device_events"]:
        rec.update(busy_share=rec["busy_s"] / wall, busy_share_profiled=rec["busy_s"] / wall_prof)
    else:
        rec["busy_share"] = "not measured (no device event in the trace)"
    print("phase 9f profile of a replan: " + json.dumps(rec), flush=True)
    return rec


def phase_continuation(device="cuda"):
    """Phase 9, parts a to f; returns their figures."""
    import torch

    mpc32, replan32 = mpc_run(torch.float32, device=device)
    mpc64, _ = mpc_run(torch.float64, device=device)
    out = dict(mpc={"float32": mpc32, "float64": mpc64}, homotopy=homotopy_run(device=device))
    out["ipopt"], out["scipy"] = adapters_run(device)
    out["live"] = live_run(device)
    out["profile"] = profile_run(replan32)
    return out


# ---------------------------------------------------------------------------
# phase 10: the multi-device layers (sharded batch and structured solves on a
# one-rank NCCL mesh and on two ranks sharing the card over gloo) and the
# solver artifacts with their cold start, on the LQR 10x10 LGL
# ---------------------------------------------------------------------------

SHARD_B = 16384
ARTIFACT_F64_B = 1024
_SPAWN_TIMEOUT = 300  # seconds for a spawn of fresh processes; all are killed past it

# two ranks sharing one card over gloo (NCCL refuses two ranks on one GPU):
# 10a's float64 rows of each rank, then 10b's structured solve of the orbit's K
_TWO_RANKS = r"""
import gc, sys, time
import numpy as np
import torch
from pockit_tpu_torch.examples.lqr import build
from pockit_tpu_torch.optimizer.ipm import default_options
from pockit_tpu_torch.parallel import (initialize_distributed, instance_mesh,
                                       make_sharded_batch_solver, make_sharded_structured_solve)
from pockit_tpu_torch.parallel.sharding import local_rows
from pockit_tpu_torch.solver import Bounds, broadcast_bounds, cuda_kkt
from pockit_tpu_torch.solver.structured import StructuredLayout
from torch.distributed.device_mesh import init_device_mesh

rank, store, data, out, device = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
assert initialize_distributed("file://" + store, num_processes=2, process_id=rank, backend="gloo")
inp = np.load(data)
system, _ = build()
c = system.compiled
mesh = instance_mesh(device_type=device)
rows = local_rows(len(inp["z0"]), mesh)
t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
z0, bc = t(inp["z0"][rows]), t(inp["bc"][rows])
bounds = broadcast_bounds(Bounds(*(t(np.asarray(b, dtype=np.float64))
                                   for b in (c.z_lb, c.z_ub, c.c_lb, c.c_ub))), z0.shape[0])
step = make_sharded_batch_solver(c, mesh, default_options(torch.float64))
cuda_kkt.reset_launches()
t0 = time.perf_counter()
res, n_conv = step(z0, bounds, {"bc": (bc,)})
torch.cuda.synchronize() if device == "cuda" else None
wall = time.perf_counter() - t0
launches = [cuda_kkt.LAUNCHES[k] for k in ("factor", "apply_down", "apply_up")]
kkt_path = step.kkt_path(torch.float64, torch.device(device))

tmesh = init_device_mesh(device, (2,), mesh_dim_names=("time",))
layout = StructuredLayout(inp["interior"], inp["reduced"], 0, int(inp["n_cols"]))
solve = make_sharded_structured_solve(layout, tmesh, "time")
K, rhs = t(inp["K"]), t(inp["rhs"])
x = solve(K, rhs)  # the first call takes the collectives' set-up
torch.cuda.synchronize() if device == "cuda" else None
t0 = time.perf_counter()
x = solve(K, rhs)
torch.cuda.synchronize() if device == "cuda" else None
np.savez(out, status=res.status.cpu().numpy(), z=res.z.cpu().numpy(), obj=res.obj.cpu().numpy(),
         n_conv=int(n_conv), own_conv=int((res.status == 0).sum()), start=rows.start, wall=wall,
         launches=launches, kkt_path=kkt_path, x=x.cpu().numpy(), structured_wall=time.perf_counter() - t0)
# drop the meshes and what holds their groups first: a gloo group that
# outlives destroy_process_group into interpreter exit can abort the process
del mesh, step, tmesh, solve
gc.collect()
torch.distributed.destroy_process_group()
"""

# cold start: a fresh process that builds the system and solves (live), or
# loads the artifacts and solves with no frontend (artifact)
_COLD = r"""
import time
t_start = time.perf_counter()
import json, sys
import numpy as np
import torch
kind, data, out, device = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions, cuda_kkt
t_import = time.perf_counter()
inp = np.load(data)
meta = json.loads(str(inp["meta"]))
opts_fast, opts_drain = IPOptions(**meta["opts_fast"]), IPOptions(**meta["opts_drain"])
if kind == "live":
    from pockit_tpu_torch.examples.lqr import build
    system, _ = build()
else:
    from pockit_tpu_torch.utils import aot
    first, drain = open(meta["first"], "rb").read(), open(meta["drain"], "rb").read()
    system = aot.install_batch_solver(None, opts_fast, first)
    aot.install_drain_round(system, opts_drain, drain)
t_ready = time.perf_counter()

def solve(system):
    cuda_kkt.reset_launches()
    t0 = time.perf_counter()
    res = ipm.solve_batch_drained(
        system, inp["z0"], bc_overrides=(inp["bc"],), optimizer_options=opts_drain,
        first_pass_options=opts_fast, drain_frac=8, max_drain_rounds=4,
        device=device, dtype=torch.float32)
    torch.cuda.synchronize() if device == "cuda" else None
    return res, time.perf_counter() - t0, [cuda_kkt.LAUNCHES[k] for k in ("factor", "apply_down", "apply_up")]

(st, obj, it, z), first_s, launches = solve(system)
t_first = time.perf_counter()
frontend = sorted(m for m in sys.modules if m.split(".")[:2] in (
    ["pockit_tpu_torch", "base"], ["pockit_tpu_torch", "lobatto"],
    ["pockit_tpu_torch", "radau"], ["pockit_tpu_torch", "transcription"]))
(st2, obj2, _, z2), second_s, _ = solve(system)
rec = dict(import_s=t_import - t_start, ready_s=t_ready - t_import, first_solve_s=first_s,
           to_first_result_s=t_first - t_start, second_solve_s=second_s, launches=launches,
           frontend_modules=frontend, converged=float((st == 0).mean()))
same = None
if kind == "artifact":  # a second load of the same bytes solves bit for bit alike
    loaded = ipm.solver_cache(system.compiled)[(opts_fast, "batch")].programs
    aot._LOADED.clear()  # so the second load deserializes the bytes anew
    again = aot.install_batch_solver(None, opts_fast, first)
    aot.install_drain_round(again, opts_drain, drain)
    anew = ipm.solver_cache(again.compiled)[(opts_fast, "batch")].programs
    (st3, _, _, z3), _, _ = solve(again)
    same = bool(all(anew[k] is not p for k, p in loaded.items())
                and np.array_equal(st3, st) and torch.equal(z3, z))
rec["second_load_bitwise"] = same
np.savez(out, status=st, obj=obj, z=z.cpu().numpy(), rec=json.dumps(rec))
"""


def spawn(argvs, timeout=_SPAWN_TIMEOUT):
    """Run one fresh Python process per ``argvs`` entry, all at once, from
    the repo root; every one is killed if one fails or they outlast
    ``timeout``. Returns their walls."""
    import os
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", *a], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in argvs]
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, results):
        if p.returncode != 0:
            raise AssertionError(f"a spawned process failed ({p.returncode}):\n{err[-3000:]}")
    return time.perf_counter() - t0


def sharded_run(B=SHARD_B, device="cuda", launched=True):
    """10a: the sharded batch solve of the LQR 10x10 LGL at B lanes: on a
    one-rank mesh (NCCL on the card) in float64 against ``ipm.solve_batch``
    of the same batch (statuses equal, z within 1e-12, n_converged == B)
    and at the float32 first-pass options (converged counts equal); then
    on two ranks sharing the device over gloo, B/2 rows each, in float64:
    every lane within 1e-10 of the unsharded solve, the reduced count the
    sum of the ranks' own. ``launched``: each run must launch all three
    kernels."""
    import torch

    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer.ipm import default_options
    from pockit_tpu_torch.parallel import instance_mesh, make_sharded_batch_solver
    from pockit_tpu_torch.solver import Bounds, IPOptions, broadcast_bounds, cuda_kkt

    system, _, x0 = lqr_problem()
    c = system.compiled
    bc = np.tile(c.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.random.default_rng(10).uniform(0.5, 1.5, B)
    mesh = instance_mesh(device_type=device)
    rec = dict(batch=B, mesh=list(mesh.mesh.shape), backend=torch.distributed.get_backend())
    out = {}
    opts_fast = IPOptions(tol=5e-6, max_iter=2, refine_steps=3, max_ls=4, soc=False,
                          feasibility_fallback=False, pallas_attempts=3, newton_residual_rtol=0.0)
    for dtype, opts in ((torch.float64, default_options(torch.float64)), (torch.float32, opts_fast)):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        z0, bc_t = t(np.tile(x0, (B, 1))), t(bc)
        bounds = broadcast_bounds(Bounds(*(t(np.asarray(b, dtype=np.float64))
                                           for b in (c.z_lb, c.z_ub, c.c_lb, c.c_ub))), B)
        want = ipm.solve_batch(system, z0, bc_overrides=(bc_t,), optimizer_options=opts)
        step = make_sharded_batch_solver(c, mesh, opts)
        cuda_kkt.reset_launches()
        t0 = time.perf_counter()
        res, n_conv = step(z0, bounds, {"bc": (bc_t,)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = str(dtype).replace("torch.", "")
        r = dict(wall_s=wall, converged_frac=float((res.status == 0).double().mean()),
                 n_converged=int(n_conv), unsharded_converged=int((want.status == 0).sum()),
                 kkt_path=step.kkt_path(dtype, torch.device(device)),
                 launches=dict(cuda_kkt.LAUNCHES), max_abs_z_diff=float((res.z - want.z).abs().max()))
        out[name] = r
        if int(n_conv) != r["unsharded_converged"] or int(n_conv) != int((res.status == 0).sum()):
            raise AssertionError(f"10a one rank {name}: n_converged {int(n_conv)} against "
                                 f"{r['unsharded_converged']}")
        if dtype == torch.float64:
            unsharded = want
            if (not torch.equal(res.status, want.status) or r["max_abs_z_diff"] > 1e-12
                    or int(n_conv) != B):
                raise AssertionError(f"10a one rank float64: {r}")
        if launched and (r["kkt_path"] != "pallas" or min(r["launches"].values()) == 0):
            raise AssertionError(f"10a one rank {name}: not the kernel path: {r}")
    rec["one_rank"] = out
    return rec, system, bc, x0, unsharded


def structured_inputs(device="cuda", mesh=40, num_point=10):
    """10b's system: the Radau orbit's condensed K at a random point, built
    as ``tests/test_parallel/test_sharded_structured.py`` builds it, and
    its layout."""
    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.solver.structured import structured_layout

    system, _ = build_orbit(radau, mesh, num_point)
    K, rhs = random_condensed_K(system, device)
    layout = structured_layout(system)
    if layout is None or layout.krylov_rank:
        raise AssertionError("10b: the orbit's layout is not an exact block-arrow pattern")
    return K, rhs, layout


def structured_run(K, rhs, layout, device="cuda"):
    """10b on one rank: the sharded structured solve against
    ``torch.linalg.solve`` (rtol 1e-8, atol 1e-9, the JAX test's) and the
    port's ``make_structured_solve`` (atol 1e-10)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from pockit_tpu_torch.parallel import make_sharded_structured_solve
    from pockit_tpu_torch.solver.structured import make_structured_solve

    K_t = torch.as_tensor(K, device=device)
    rhs_t = torch.as_tensor(rhs, device=device)
    solve = make_sharded_structured_solve(layout, init_device_mesh(device, (1,), mesh_dim_names=("time",)),
                                          "time")
    solve(K_t, rhs_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = solve(K_t, rhs_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x_dense = torch.linalg.solve(K_t, rhs_t).cpu().numpy()
    x_un = make_structured_solve(layout)(K_t, rhs_t)[0].cpu().numpy()
    return x.cpu().numpy(), x_dense, x_un, wall


def check_structured(x, x_dense, x_un, what):
    if not (np.allclose(x, x_dense, rtol=1e-8, atol=1e-9) and np.abs(x - x_un).max() <= 1e-10):
        raise AssertionError(f"10b {what}: off torch.linalg.solve by {np.abs(x - x_dense).max():.3e}, "
                             f"off make_structured_solve by {np.abs(x - x_un).max():.3e}")


def artifact_run(system, x0, tmp, B=SHARD_B, f64_B=ARTIFACT_F64_B, device="cuda", launched=True):
    """10c: the first-pass and drain-round artifacts of the float32 bench
    solve at B lanes; cold start in fresh processes, live (import, build,
    first drained solve) then from the artifacts (import, load, install,
    first drained solve, no frontend module), each with a second solve
    in the same process; the artifacts' statuses equal the live ones, and a
    second load of the same bytes solves bit for bit alike. Then a float64
    batch artifact at ``f64_B`` lanes against the live solve (obj rtol
    1e-12, z atol 1e-10, the JAX test's)."""
    import dataclasses

    import torch

    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import IPOptions
    from pockit_tpu_torch.utils import aot

    opts_fast = IPOptions(tol=5e-6, max_iter=2, refine_steps=3, max_ls=4, soc=False,
                          feasibility_fallback=False, pallas_attempts=3, newton_residual_rtol=0.0)
    opts_drain = IPOptions(tol=5e-6, max_iter=80, refine_steps=3, pallas_attempts=3,
                           newton_residual_rtol=0.0)
    f32 = dict(device=device, dtype=torch.float32)
    t0 = time.perf_counter()
    first = aot.export_batch_solver(system, B, opts_fast, **f32)
    drain = aot.export_drain_round(system, B, B // 8, opts_drain, **f32)
    rec = dict(batch=B, export_s=time.perf_counter() - t0, artifact_bytes=[len(first), len(drain)])
    paths = {k: f"{tmp}/{aot.artifact_name('lqr_' + k, B, **f32)}" for k in ("first", "drain")}
    for k, blob in (("first", first), ("drain", drain)):
        with open(paths[k], "wb") as fh:
            fh.write(blob)
    bc = np.tile(system.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.random.default_rng(11).uniform(0.5, 1.5, B)
    meta = dict(opts_fast=dataclasses.asdict(opts_fast), opts_drain=dataclasses.asdict(opts_drain),
                **paths)
    np.savez(f"{tmp}/cold.npz", z0=np.tile(x0, (B, 1)).astype(np.float32), bc=bc.astype(np.float32),
             meta=json.dumps(meta))
    runs = {}
    for kind in ("live", "artifact"):  # one after the other: each a cold start alone
        wall = spawn([[_COLD, kind, f"{tmp}/cold.npz", f"{tmp}/{kind}.npz", device]])
        got = np.load(f"{tmp}/{kind}.npz")
        runs[kind] = dict(json.loads(str(got["rec"])), process_wall_s=wall)
        runs[kind]["status"] = got["status"]
    rec.update({k: {n: v for n, v in r.items() if n != "status"} for k, r in runs.items()})
    live, art = runs["live"], runs["artifact"]
    if not np.array_equal(live["status"], art["status"]) or not art["second_load_bitwise"]:
        raise AssertionError(f"10c: the artifacts' statuses differ from the live solve's, or a "
                             f"second load does not solve alike: {rec}")
    if art["frontend_modules"]:
        raise AssertionError(f"10c: the artifact process imported the frontend: {art['frontend_modules']}")
    if live["converged"] < 0.99:
        raise AssertionError(f"10c: the live cold solve converged {live['converged']}")
    if launched and min(art["launches"]) == 0:
        raise AssertionError(f"10c: the artifact solve did not launch every kernel: {art['launches']}")

    # float64 pair, in this process
    opts = IPOptions(tol=1e-9)
    f64 = dict(device=device, dtype=torch.float64)
    call = aot.load_batch_solver(aot.export_batch_solver(system, f64_B, opts, **f64))
    z0 = torch.as_tensor(np.tile(x0, (f64_B, 1)), **f64)
    bc_t = torch.as_tensor(bc[:f64_B], **f64)
    res_aot = call(z0, bc_t)
    res_live = ipm.solve_batch(system, z0, bc_overrides=(bc_t,), optimizer_options=opts)
    obj_rel = float(((res_aot.obj - res_live.obj).abs() / res_live.obj.abs()).max())
    z_abs = float((res_aot.z - res_live.z).abs().max())
    rec["float64_pair"] = dict(batch=f64_B, max_rel_obj=obj_rel, max_abs_z=z_abs,
                               converged=float((res_aot.status == 0).double().mean()))
    if obj_rel > 1e-12 or z_abs > 1e-10 or not bool((res_aot.status == 0).all()):
        raise AssertionError(f"10c float64 pair: {rec['float64_pair']}")
    return rec


def phase_multidevice(device="cuda", B=SHARD_B, f64_B=ARTIFACT_F64_B, orbit=(40, 10), launched=True):
    """Phase 10, parts a to c; returns their figures. Leaves no process
    group behind."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        try:
            rec_a, system, bc, x0, unsharded = sharded_run(B, device, launched)
            K, rhs, layout = structured_inputs(device, *orbit)
            x1, x_dense, x_un, wall1 = structured_run(K, rhs, layout, device)
            check_structured(x1, x_dense, x_un, "one rank")
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        # two ranks sharing the device over gloo: 10a's float64 rows, then 10b
        np.savez(f"{tmp}/two.npz", z0=np.tile(x0, (B, 1)), bc=bc, K=K, rhs=rhs,
                 interior=layout.interior, reduced=layout.reduced, n_cols=layout.n_cols)
        wall = spawn([[_TWO_RANKS, str(r), f"{tmp}/store", f"{tmp}/two.npz", f"{tmp}/rank{r}.npz",
                       device] for r in range(2)])
        ranks = [np.load(f"{tmp}/rank{r}.npz") for r in range(2)]
        z = np.concatenate([r["z"] for r in ranks])
        status = np.concatenate([r["status"] for r in ranks])
        two = dict(process_wall_s=wall, ranks=[dict(
            rows=[int(r["start"]), int(r["start"]) + B // 2], wall_s=float(r["wall"]),
            converged_frac=float((r["status"] == 0).mean()), n_converged=int(r["n_conv"]),
            launches=dict(zip(("factor", "apply_down", "apply_up"), r["launches"].tolist())),
            kkt_path=str(r["kkt_path"]), structured_wall_s=float(r["structured_wall"])) for r in ranks],
            max_abs_z_diff=float(np.abs(z - unsharded.z.cpu().numpy()).max()))
        rec_a["two_ranks"] = two
        print("phase 10a sharded batch solve: " + json.dumps(rec_a), flush=True)
        own = sum(int(r["own_conv"]) for r in ranks)
        if any(int(r["n_conv"]) != own for r in ranks) or two["max_abs_z_diff"] > 1e-10 or \
                not np.array_equal(status, unsharded.status.cpu().numpy()):
            raise AssertionError(f"10a two ranks: {two}")
        if launched and any(r["kkt_path"] != "pallas" or min(r["launches"].values()) == 0
                            for r in two["ranks"]):
            raise AssertionError(f"10a two ranks: a rank did not launch every kernel: {two}")
        for r in ranks:
            check_structured(r["x"], x_dense, x_un, f"rank {int(r['start']) // (B // 2)} of two")
        rec_b = dict(orbit=list(orbit), L=int(K.shape[0]), n_blocks=int(layout.interior.shape[0]),
                     one_rank_wall_s=wall1, two_rank_walls_s=[float(r["structured_wall"]) for r in ranks],
                     max_abs_dense=float(max(np.abs(x - x_dense).max() for x in [x1] + [r["x"] for r in ranks])),
                     max_abs_structured=float(max(np.abs(x - x_un).max() for x in [x1] + [r["x"] for r in ranks])))
        print("phase 10b sharded structured solve: " + json.dumps(rec_b), flush=True)
        rec_c = artifact_run(system, x0, tmp, B, f64_B, device, launched)
        print("phase 10c artifacts and cold start: " + json.dumps(rec_c), flush=True)
    return dict(sharded=rec_a, structured=rec_b, artifact=rec_c)


# ---------------------------------------------------------------------------
# phase 11: the LOQO barrier rule, the unrolled block core, the native nodes
# ---------------------------------------------------------------------------

MU_STRATEGIES = ("monotone", "adaptive", "mehrotra")
UNROLLED_B = (1024, 64)  # 11c: each K batch, and its first 64 lanes alone
UNROLLED_SOLVE_B = 64


def mu_gate_problems():
    """The five gates of ``tools/compare_mu.py``, built with the port: name
    -> a constructor of ``(system, guess)``."""
    import sympy as sp

    import pockit_tpu_torch.lobatto as lobatto
    import pockit_tpu_torch.radau as radau

    def lqr():
        return lqr_problem()[:2]

    def brach():
        system = lobatto.System(0)
        phase = system.new_phase(["x", "y", "v"], ["theta"])
        x, y, v = phase.x
        (theta,) = phase.u
        phase.set_dynamics([v * sp.sin(theta), -v * sp.cos(theta), 9.8 * sp.cos(theta)])
        phase.set_integral([1])
        phase.set_boundary_condition([0, 0, 0], [2, -2, None], 0, None)
        phase.set_discretization(10, 8)
        system.set_phase([phase])
        system.set_objective(phase.I[0])
        guess = lobatto.linear_guess(phase, 0.5)
        guess.t_f = 1.0
        return system, guess

    def bang():
        system = radau.System(0)
        phase = system.new_phase(["x", "v"], ["u"])
        x, v = phase.x
        (u,) = phase.u
        phase.set_dynamics([v, u])
        phase.set_integral([1])
        phase.set_phase_constraint([u, phase.t], [-1.0, 0.5], [1.0, 6.0],
                                   bang_bang_control=[True, False])
        phase.set_boundary_condition([0.0, 0.0], [1.0, 0.0], 0.0, None)
        phase.set_discretization(3, 6)
        system.set_phase([phase])
        system.set_objective(phase.I[0])
        guess = radau.linear_guess(phase, 0.5)
        guess.t_f = 3.0
        return system, guess

    return {"lqr": lqr, "brach": brach, "bang": bang,
            "orbit": lambda: build_orbit(lobatto, 15, 8),
            "goddard": lambda: build_goddard(radau)}


def mu_run(device="cuda"):
    """11a: each gate of ``tools/compare_mu.py`` solved once per barrier rule,
    one lane, float64, tol 1e-8, ``kkt_solver="auto"``; iterations, status,
    objective and launches per kernel. Gates: no run raises; where the
    adaptive and monotone rules both converge, objectives within 1e-6
    (relative to max(1, |objective|)); on the card, the adaptive LQR
    launches all three kernels."""
    import torch

    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import IPOptions, cuda_kkt

    recs = {}
    for name, build in mu_gate_problems().items():
        for strategy in MU_STRATEGIES:
            system, guess = build()
            cuda_kkt.reset_launches()
            t0 = time.perf_counter()
            _, info = ipm.solve(system, guess, IPOptions(tol=1e-8, mu_strategy=strategy),
                                device=device, dtype=torch.float64)
            rec = dict(iterations=int(info["iterations"]), status=int(info["status"]),
                       objective=float(info["obj_val"]), kkt_solver=info["kkt_solver"],
                       wall_s=time.perf_counter() - t0, launches=dict(cuda_kkt.LAUNCHES))
            recs.setdefault(name, {})[strategy] = rec
            print(f"phase 11a {name} {strategy}: " + json.dumps(rec), flush=True)
    for name, r in recs.items():
        ad, mono = r["adaptive"], r["monotone"]
        if ad["status"] == 0 == mono["status"] and \
                abs(ad["objective"] - mono["objective"]) > 1e-6 * max(1.0, abs(mono["objective"])):
            raise AssertionError(f"11a {name}: adaptive {ad['objective']} against monotone "
                                 f"{mono['objective']}")
    if torch.device(device).type == "cuda" and min(recs["lqr"]["adaptive"]["launches"].values()) == 0:
        raise AssertionError(f"11a: the adaptive LQR did not launch every kernel: {recs['lqr']}")
    return recs


def random_condensed_K(system, device="cuda", seed=0, around=None):
    """A system's condensed K at a random point, as
    ``tests/test_parallel/test_sharded_structured.py`` builds it (W + a
    positive diagonal + J^T D J, shifted to SPD), and a right-hand side.
    The point is U(0.5, 1.2) in every entry, or with ``around`` (a point of
    the problem) that point scaled entrywise by U(0.99, 1.01)."""
    compiled = system.compiled
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 1.2, system.L) if around is None else around * rng.uniform(0.99, 1.01, system.L)
    lam = rng.normal(0, 1, compiled.m)
    W = compiled.hessian(z, lam, 1.0, device=device).cpu().numpy()
    J = compiled.jacobian(z, device=device).cpu().numpy()
    K = W + np.diag(rng.uniform(0.1, 5.0, system.L)) + (J.T * rng.uniform(0.1, 10.0, compiled.m)) @ J
    ev = np.linalg.eigvalsh(K)
    if ev.min() < 1e-6:
        K = K + (1e-3 - min(ev.min(), 0)) * np.eye(system.L)
    return K, rng.normal(size=system.L)


def block_batch(system, B, dtype, device="cuda", around=None):
    """11c's inputs: ``system``'s condensed K at a random point
    (:func:`random_condensed_K`, ``around``) in the block core's storage (phantom
    slots of a ragged layout read 0, with a unit pivot), and ``B`` lanes of
    it, lane l scaled as D_l K D_l by its own positive diagonal
    exp(0.05 N(0, 1)) (SPD, the same pattern), each with a normal
    right-hand side; ``default_rng(1)``. Returns the layout's
    ``(interior, reduced, n)`` and the lanes' ``(K_ii, K_ir, K_rr, rhs)``."""
    import torch

    from pockit_tpu_torch.solver.structured import structured_layout

    layout = structured_layout(system)
    interior, reduced = np.asarray(layout.interior, np.int64), np.asarray(layout.reduced, np.int64)
    K, _ = random_condensed_K(system, device, around=around)
    n = K.shape[0]
    K_ext = np.pad(K, ((0, 1), (0, 1)))
    K_ii = K_ext[interior[:, :, None], interior[:, None, :]] + \
        np.eye(interior.shape[1]) * (interior >= n)[:, :, None]
    K_ir = K_ext[interior[:, :, None], reduced[None, None, :]]
    K_rr = K[np.ix_(reduced, reduced)]
    rng = np.random.default_rng(1)
    d = np.exp(0.05 * rng.normal(size=(B, n + 1)))
    d[:, n] = 1.0
    rhs = rng.normal(size=(B, n))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    d_i, d_r = t(d[:, interior]), t(d[:, reduced])
    K_ii = d_i[..., :, None] * t(K_ii) * d_i[..., None, :]
    K_ir = d_i[..., :, None] * t(K_ir) * d_r[:, None, None, :]
    K_rr = d_r[:, :, None] * t(K_rr) * d_r[:, None, :]
    return (interior, reduced, n), (K_ii, K_ir, K_rr, t(rhs))


def core_pass(core, blocks, lanes, device):
    """One factor and one apply of ``core`` on the first ``lanes`` lanes of
    ``blocks``; returns ``(x, p_min, p_max, factors...)`` and the seconds."""
    import torch

    factor, apply_ = core
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    K_ii, K_ir, K_rr, rhs = (b[:lanes] for b in blocks)
    sync()
    t0 = time.perf_counter()
    factors, p_min, p_max = factor(K_ii, K_ir, K_rr)
    x = apply_(factors, rhs)
    sync()
    return (x, p_min, p_max) + tuple(factors), time.perf_counter() - t0


def unrolled_run(device="cuda", sizes=UNROLLED_B, solve_B=UNROLLED_SOLVE_B):
    """11c: the unrolled block core against itself across batch sizes and
    against the lax core. The K batches of the LQR 10x10 LGL, the 3-phase
    Goddard and the 40x10 Radau orbit (:func:`block_batch`), factored and
    applied at ``sizes[0]`` lanes and at the first ``sizes[1]`` alone, in
    float64 and float32. Gates: the unrolled core gives every lane the same
    bits at both sizes; in float64 it agrees with lax within 1e-9
    (relative to each lane's largest entry). Lax's own invariance is
    printed. Then the Goddard at ``solve_B`` lanes, float64, on the block
    path with each core (gated as phase 6's float64 run), wall and
    iterations side by side."""
    import torch

    import pockit_tpu_torch.radau as radau
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver.structured import make_block_arrow_core

    big, small = sizes
    goddard, guess = build_goddard(radau)
    # the Goddard's point is drawn around its guess: at U(0.5, 1.2) the drag
    # exp(-500 (h - 1)) puts 1e225 into K (condition number 9e15)
    systems = {"lqr": (lqr_problem()[0], None), "goddard": (goddard, preprocess(goddard, guess)[0]),
               "orbit": (build_orbit(radau)[0], None)}
    recs = {}
    for name, (system, around) in systems.items():
        for dtype in (torch.float64, torch.float32):
            (interior, reduced, n), blocks = block_batch(system, big, dtype, device, around)
            out = {}
            for method in ("unrolled", "lax"):
                core = make_block_arrow_core(interior, reduced, n, method=method)
                core_pass(core, blocks, small, device)  # warm-up
                res_big, s_big = core_pass(core, blocks, big, device)
                res_small, s_small = core_pass(core, blocks, small, device)
                same = all(torch.equal(a[:small], b) for a, b in zip(res_big, res_small))
                diff = max(float((a[:small] - b).abs().max()) for a, b in zip(res_big, res_small))
                out[method] = dict(seconds=[s_big, s_small], bitwise=same, max_abs_diff=diff,
                                   x=res_big[0], finite=bool(torch.isfinite(res_big[0]).all()))
                del res_big, res_small
            x_u, x_l = out["unrolled"].pop("x"), out["lax"].pop("x")
            rel = float(((x_u - x_l).abs().amax(-1) / x_l.abs().amax(-1)).max())
            dt = str(dtype).replace("torch.", "")
            recs[f"{name}_{dt}"] = rec = dict(
                shape=[int(interior.shape[0]), int(interior.shape[1]), len(reduced)],
                lanes=[big, small], unrolled=out["unrolled"], lax=out["lax"],
                max_rel_unrolled_vs_lax=rel)
            print(f"phase 11c core {name} {dt}: " + json.dumps(rec), flush=True)
            if not (out["unrolled"]["bitwise"] and out["unrolled"]["finite"]):
                raise AssertionError(f"11c {name} {dt}: the unrolled core is not batch-invariant")
            if dtype == torch.float64 and rel > 1e-9:
                raise AssertionError(f"11c {name} {dt}: unrolled off lax by {rel:.3e}")
            del blocks, x_u, x_l
    solves = {core: gate_run("goddard", "f64_block", solve_B, device, block_core=core, phase="11c")
              for core in ("unrolled", "lax")}
    return dict(cores=recs, goddard=solves)


def native_run():
    """11d: whether the port's C++ node library loaded and its build
    seconds; where it did, its LGL and LGR nodes for 2-64 points against
    the numpy path (nodes 1e-13, weights 2e-13: the C++ LGR nodes get no
    Newton polish, and the JAX package's own library sits 1.52e-13 from the
    numpy path at 39 points) and its Gauss nodes against
    ``numpy.polynomial.legendre.leggauss`` (1e-13)."""
    from pockit_tpu_torch.numerics import native, quadrature

    info = native.build_info()
    rec = dict(loaded=info["loaded"], build_s=info["seconds"])
    if info["loaded"]:
        errs = {"lgl": [0.0, 0.0], "lgr": [0.0, 0.0], "gauss": [0.0, 0.0]}
        for n in range(2, 65):
            for fam, want in (("lgl", quadrature._lgl_numpy(n)), ("lgr", quadrature._lgr_numpy(n)),
                              ("gauss", np.polynomial.legendre.leggauss(n))):
                got = getattr(native, fam)(n)
                errs[fam] = [max(e, float(np.abs(g - w).max())) for e, g, w in zip(errs[fam], got, want)]
        rec["max_abs_nodes_weights"] = errs
    print("phase 11d native nodes: " + json.dumps(rec), flush=True)
    if info["loaded"] and (max(e[0] for e in errs.values()) > 1e-13 or errs["gauss"][1] > 1e-13
                           or max(errs["lgl"][1], errs["lgr"][1]) > 2e-13):
        raise AssertionError(f"11d: native nodes off the numpy path: {errs}")
    return rec


def bench_batches(system, x0, B, opts_fast, opts_drain, reps, draw, rng):
    """Phase 4's drained LQR batches (``bench.py``'s two-stage solve) on the
    card at ``B`` lanes: one warm-up, then ``reps`` timed batches, each on a
    fresh x(0) draw (``draw(rng, B, dtype) -> (bc, bc on the card)``);
    returns their figures (launches summed over the timed batches)."""
    import torch

    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.solver import cuda_kkt

    x0b = torch.as_tensor(np.tile(x0, (B, 1)), dtype=torch.float32, device="cuda")

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
    for _ in range(reps):
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
    return dict(
        batch=B, reps=reps, mu_strategy=opts_drain.mu_strategy,
        converged_frac=float(np.mean(convs)), first_pass_frac=float(np.mean(firsts)),
        mean_iters=float(np.mean(iters)), max_objective_parity_error=float(np.max(parity)),
        wall_s_per_batch=wall, walls=walls, solves_per_s=B / wall, warmup_s=warm_s,
        max_memory_allocated=int(torch.cuda.max_memory_allocated()), launches=launches,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed repetitions of phase 4")
    ap.add_argument("--batch", type=int, default=16384, help="phase 4 batch size")
    ap.add_argument("--residual-rtol", type=float, default=0.0,
                    help="phase 4 newton_residual_rtol (bench.py runs the default 1e-2)")
    ap.add_argument("--gate-batch", type=int, default=1024,
                    help="lanes of phases 5 and 6 and of their kernel checks")
    ap.add_argument("--first-pass", choices=sorted(GATES),
                    help="run only this float32 gate's first pass on both paths")
    ap.add_argument("--device", default="cuda", help="--first-pass: cuda or cpu")
    ap.add_argument("--lanes", type=int, default=1024, help="--first-pass: lanes of the draw")
    args = ap.parse_args()
    if args.first_pass:
        first_pass(args.first_pass, args.lanes, args.device)
        return
    started = time.perf_counter()
    seconds = {}

    import dataclasses

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
    from pockit_tpu_torch.examples.lqr import build as lqr_build
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.optimizer._common import preprocess
    from pockit_tpu_torch.solver import IPOptions
    from pockit_tpu_torch.solver import _build, cuda_kkt

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build_info()
    print(f"phase 1 build: {info['seconds']:.1f} s nvcc ({time.perf_counter() - t0:.1f} s with load)",
          flush=True)
    seconds["0-1"] = time.perf_counter() - started
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
    # the padded shapes of phases 5 and 6, before they solve there
    gate_kernels = {}
    for gate, (_, (nb, ni, nr)) in GATE_SHAPES.items():
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-11)):
            inputs = ragged_inputs(dtype, nb, ni, nr, args.gate_batch)
            phase_ragged(dtype, tol, nb, ni, nr, attempts=1, lanes=args.gate_batch, inputs=inputs)
            gate_kernels[gate, dtype] = phase_ragged(dtype, tol, nb, ni, nr, attempts=3,
                                                     lanes=args.gate_batch, timed=True,
                                                     inputs=inputs)
            del inputs
    t2 = time.perf_counter()
    seconds["2"] = t2 - started - seconds["0-1"]

    system, phase = lqr_build()
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
    t3 = time.perf_counter()
    seconds["3"] = t3 - t2

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
    rng = np.random.default_rng(0)
    metrics = bench_batches(system, x0, B, opts_fast, opts_drain, args.reps, draw, rng)
    metrics.update(newton_residual_rtol=args.residual_rtol, device=name, power_limit=smi)
    launches = metrics["launches"]
    print("phase 4 float32 bench: " + json.dumps(metrics), flush=True)
    if metrics["converged_frac"] < 0.99:
        raise AssertionError(f"converged_frac {metrics['converged_frac']} < 0.99")
    if metrics["max_objective_parity_error"] > 5e-6:
        raise AssertionError("objective parity above the float32 gate 5e-6")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    t4 = time.perf_counter()
    seconds["4"] = t4 - t3

    # -- phase 9: continuation and MPC, the adapters, the ops hooks -------------
    cont = phase_continuation()
    t9 = time.perf_counter()
    seconds["9"] = t9 - t4

    # -- phase 10: the multi-device layers, the solver artifacts ----------------
    multi = phase_multidevice()
    t4 = time.perf_counter()
    seconds["10"] = t4 - t9

    # -- phase 11b, d: the bench batch under the LOQO rule, the native nodes ----
    # (11a and 11c, single-lane solves and the unrolled core, run in the pool)
    adaptive = bench_batches(
        system, x0, B, dataclasses.replace(opts_fast, mu_strategy="adaptive"),
        dataclasses.replace(opts_drain, mu_strategy="adaptive"), 1, draw, rng)
    adaptive["phase_4_monotone"] = {k: metrics[k] for k in (
        "converged_frac", "first_pass_frac", "mean_iters", "wall_s_per_batch", "solves_per_s")}
    adaptive["phase_4_monotone"]["launches_per_batch"] = {k: v / args.reps for k, v in launches.items()}
    print("phase 11b float32 bench, adaptive: " + json.dumps(adaptive), flush=True)
    if adaptive["max_objective_parity_error"] > 5e-6:
        raise AssertionError("11b: objective parity above the float32 gate 5e-6")
    native_run()
    t11 = time.perf_counter()
    seconds["11b, 11d"] = t11 - t4

    # -- phases 5 to 8, 11a, 11c: the gates, the refine sweep, F1; the barrier
    # rules on compare_mu's gates, the unrolled core ----------------------------
    torch.cuda.empty_cache()  # the runs' processes need the card's memory
    gates, sweeps, _, pooled = phase_pool(args.gate_batch)
    barrier = pooled["mu"]
    t8 = time.perf_counter()
    seconds["5-8, 11a, 11c"] = t8 - t11
    sweep_kernels(sweeps)
    seconds["7 kernels"] = time.perf_counter() - t8
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()})
          + f" total {time.perf_counter() - started:.1f}", flush=True)

    src = "pockit_tpu_torch/csrc/block_arrow_kkt.cu"
    replaces = {"factor": "pockit_tpu/solver/pallas_kkt.py:160",
                "apply_down": "pockit_tpu/solver/pallas_kkt.py:385",
                "apply_up": "pockit_tpu/solver/pallas_kkt.py:403"}
    # the bound of the timed phase-2 calls: bench shapes, float32, B=16384
    cost = {k: cuda_kkt.kernel_cost(k, 10, 16, 32, 16384, torch.float32,
                                    retries32 if k == "factor" else 0)
            for k in replaces}
    def at_gate(k, gate, dtype):
        """Kernel ``k`` at a gate's padded shape and type: phase 2's times
        and error there, its bound, and the launches per batch of that
        gate's run through the kernels in that type."""
        g = gate_kernels[gate, dtype]
        nb, ni_p, nr_p = g["shape"]
        c = cuda_kkt.kernel_cost(k, nb, ni_p, nr_p, g["lanes"], dtype,
                                 g["chol_retries"] if k == "factor" else 0)
        run = gates[gate]["f64" if dtype == torch.float64 else "f32"]
        return {"dtype": str(dtype).replace("torch.", ""), "shape": [nb, ni_p, nr_p],
                "lanes": g["lanes"], "launches_per_batch": run["launches"][k],
                "max_abs_err": g["abs_err"][k], "ms": g["times"][k][0], "plain_ms": g["times"][k][1],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "bytes": c["bytes"],
                "ops": c["ops"], "library_ms": None}

    def at_sweep(k, run, padded):
        """Kernel ``k`` at a padded shape of phase 7's ``run``: the times and
        error measured there, its bound, and its launches in the sweep at
        that shape."""
        g = sweeps[run]["kernels"][padded]
        dtype = torch.float32 if run == "f32" else torch.float64
        nb, ni_p, nr_p = g["shape"]
        c = cuda_kkt.kernel_cost(k, nb, ni_p, nr_p, g["lanes"], dtype)
        return {"run": run, "dtype": str(dtype).replace("torch.", ""), "shape": [nb, ni_p, nr_p],
                "lanes": g["lanes"], "launches_per_sweep": g["launches_per_sweep"][k],
                "max_abs_err": g["abs_err"][k], "ms": g["times"][k][0],
                "plain_ms": g["times"][k][1], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "bytes": c["bytes"], "ops": c["ops"], "library_ms": None}

    def at_mpc(k):
        """Kernel ``k`` in phase 9a: its launches per cold solve and per
        replan in each type, and in 9f's profiled float32 replan its device
        ms per launch (from the trace) beside the bound of one launch."""
        traced = cont["profile"].get("port_kernels", {}).get(k)
        c = cuda_kkt.kernel_cost(k, *LQR_PADDED, MPC_B, torch.float32)
        return {"shape": list(LQR_PADDED), "batch": MPC_B, **{
            dt: {run: cont["mpc"][dt][run]["launches"][k] for run in ("cold", "replan")}
            for dt in ("float32", "float64")},
            "float32_replan_trace_ms": traced["s"] * 1e3 / traced["launches"] if traced else None,
            "float32_bound_ms": c["bound_ms"], "bound_by": c["bound_by"]}

    def at_sharded(k):
        """Kernel ``k`` in phase 10: its launches on the one-rank mesh in
        each type and on each of the two ranks (float64), all at B=16384,
        and in 10c's first drained solve from the artifacts."""
        a = multi["sharded"]
        return {"batch": SHARD_B, "shape": list(LQR_PADDED),
                "one_rank": {dt: a["one_rank"][dt]["launches"][k] for dt in ("float64", "float32")},
                "two_ranks_float64": [r["launches"][k] for r in a["two_ranks"]["ranks"]],
                "artifact_first_solve": multi["artifact"]["artifact"]["launches"][list(replaces).index(k)]}

    def at_barrier(k):
        """Kernel ``k`` in phase 11: its launches in each single-lane solve of
        11a (gate, then barrier rule) and per batch of 11b (adaptive); 11c
        runs no kernel."""
        return {"11a": {gate: {mu: r["launches"][k] for mu, r in runs.items()}
                        for gate, runs in barrier.items()},
                "11b_adaptive_per_batch": adaptive["launches"][k]}

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "launches_per_batch": launches[k] / args.reps,
         "max_abs_err": errs32[k][0], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": cost[k]["bound_ms"], "bound_by": cost[k]["bound_by"],
         "bytes": cost[k]["bytes"], "ops": cost[k]["ops"], "library_ms": None,
         "gates": {f"{gate}_{str(dt).replace('torch.', '')}": at_gate(k, gate, dt)
                   for gate in GATE_SHAPES for dt in (torch.float64, torch.float32)},
         "sweep": [at_sweep(k, run, padded) for run in ("f32", "f64", "bang_bang")
                   for padded in sweeps[run]["kernels"]],
         "mpc": at_mpc(k), "sharded": at_sharded(k), "barrier": at_barrier(k)}
        for k in replaces]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
