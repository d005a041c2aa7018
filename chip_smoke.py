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
   the phase's padded shape. The six runs go four at a time, each in a
   process of its own: their IPM loops are bound by the host.

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
batch. The last line is ``{"ok": true, "device": {...}}``.
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
    retried = bool((fac[6][3] > 0).any())
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


def gate_run(name, run, B, device="cuda"):
    """One run of a configuration of tools/bench_gates.py through the
    port's ``solve_batch_drained`` on ``B`` lanes (drain rounds of B/8
    stragglers, as the tool): ``run`` is "f64" or "f32" through the kernels
    (on the CPU, their plain versions) or "f32_block" through the plain
    block core. Raises on a failed gate; returns the run's figures."""
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
    dtype = torch.float64 if run == "f64" else torch.float32
    if run == "f64":
        fast = IPOptions(tol=1e-7, max_iter=60, refine_steps=3)
    else:
        fast = IPOptions(tol=tol32, max_iter=60, refine_steps=3, mu_strategy=mu32,
                         delta_w_min=dwmin32)
    kkt = "block" if run == "f32_block" else ("auto" if on_card else "pallas")
    fast = dataclasses.replace(fast, kkt_solver=kkt)
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
        gate=name, run=run, batch=B, kkt_solver=kkt, tol=fast.tol,
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
    print(f"phase {5 if name == 'orbit' else 6} {name} {run}: " + json.dumps(rec), flush=True)
    if not rec["finite"]:
        raise AssertionError(f"{name} {run}: non-finite results")
    if kkt != "block" and (min(launches.values()) == 0
                           or any(shapes[k] != [padded] for k in shapes)):
        raise AssertionError(f"{name} {run}: the kernels did not all launch at {padded}: "
                             f"{launches} {shapes}")
    tol_obj = {"orbit": 5e-3, "goddard": 1e-3}[name] if run == "f64" else tol_obj32
    if rec["parity_err_lane0"] > tol_obj:
        raise AssertionError(f"{name} {run}: lane 0 {obj_name} {rec['lane0_objective']} is "
                             f"more than {tol_obj} from {obj_star}")
    if name == "goddard" and rec["lane0_pinned_err"] > 1e-6:
        raise AssertionError(f"{name} {run}: pinned controls off by {rec['lane0_pinned_err']}")
    if run == "f64" and rec["converged_frac"] < 0.99:
        raise AssertionError(f"{name} f64: converged_frac {rec['converged_frac']} < 0.99")
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


# every run of phases 5 and 6, the longest first (an H100 with its host:
# the orbit's float64 run is bound by its factor, the rest by the host)
GATE_RUNS = (("orbit", "f64"), ("goddard", "f32_block"), ("goddard", "f32"), ("orbit", "f32"),
             ("orbit", "f32_block"), ("goddard", "f64"))


def _gate_worker_init():
    import torch

    torch.set_num_threads(2)  # the runs share the host's cores


def phase_gates(B, device="cuda", workers=4):
    """Phases 5 and 6: every run of :data:`GATE_RUNS`, ``workers`` at a
    time, each in a process of its own (spawned; the IPM loops are bound
    by the host, so runs side by side share the card and use more of the
    host's cores). Then the float32 kernels against the block core of each
    configuration. Raises on a failed gate (after the runs in flight end;
    the pool's processes are stopped); returns ``{gate: {run: figures}}``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_gate_worker_init) as pool:
        futures = {key: pool.submit(gate_run, *key, B, device) for key in GATE_RUNS}
        try:
            done = {key: f.result() for key, f in futures.items()}
        except BaseException:
            for f in futures.values():
                f.cancel()
            raise
    out = {}
    for (gate, run), rec in done.items():
        out.setdefault(gate, {})[run] = rec
    for gate, runs in out.items():
        gap = runs["f32"]["converged_frac"] - runs["f32_block"]["converged_frac"]
        print(f"phase {5 if gate == 'orbit' else 6} {gate} float32 kernels against block core: "
              f"converged {runs['f32']['converged_frac']:.4f} against "
              f"{runs['f32_block']['converged_frac']:.4f} (gap {gap:+.4f})", flush=True)
        if gap < -0.01:
            raise AssertionError(f"{gate} f32: the kernels converged fewer lanes than the block "
                                 f"core by more than 1%")
    return out


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
    t4 = time.perf_counter()
    seconds["4"] = t4 - t3

    # -- phases 5 and 6: the orbit transfer and Goddard gates ------------------
    torch.cuda.empty_cache()  # the runs' processes need the card's memory
    gates = phase_gates(args.gate_batch)
    seconds["5-6"] = time.perf_counter() - t4
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

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "launches_per_batch": launches[k] / args.reps,
         "max_abs_err": errs32[k][0], "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": cost[k]["bound_ms"], "bound_by": cost[k]["bound_by"],
         "bytes": cost[k]["bytes"], "ops": cost[k]["ops"], "library_ms": None,
         "gates": {f"{gate}_{str(dt).replace('torch.', '')}": at_gate(k, gate, dt)
                   for gate in GATE_SHAPES for dt in (torch.float64, torch.float32)}}
        for k in replaces]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
