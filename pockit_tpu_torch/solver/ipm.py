"""Batched primal-dual interior-point method with a filter line search.

The port of ``pockit_tpu/solver/ipm.py``. Design, as in the reference:

- **One condensed SPD solve per iteration.** Slacks and bound duals are
  eliminated analytically; equality rows get dual regularization so
  ``K = W + Σ_z + δ_w I + Jᵀ D J`` is SPD after inertia correction. On
  the block-arrow paths ("block", "pallas") ``K`` is assembled in
  block-arrow storage from pointwise AD (``transcription/kkt.py``) and
  factored by the plain torch block core or the hand-written CUDA kernels
  (``solver/cuda_kkt.py``), with J and W acting matrix-free; the "dense"
  and "structured" paths materialize J, W and ``K`` per lane and factor
  it with a Jacobi-equilibrated dense Cholesky or with the block core on
  the block-arrow pattern gathered out of it (``solver/structured.py``).
- **Wächter-Biegler filter line search** with second-order correction and
  a Gauss-Newton feasibility fallback.
- **Barrier update**: the monotone Fiacco-McCormick ladder, Mehrotra
  probing (``mu_strategy="mehrotra"``): the factorization's first solve is
  the affine (mu = 0) step, whose complementarity retargets mu by the
  cubic rule; the centred and corrected right-hand side is then solved
  against the same factors; or the LOQO centrality rule
  (``mu_strategy="adaptive"``): mu from the spread of the complementarity
  products, every iteration, with no filter reset.

**Batch-first.** Every state tensor carries a leading lane axis ``B``. The
reference runs one lane's solve under ``jax.vmap``; a vmapped
``lax.while_loop`` runs its body for every lane while any lane's condition
holds and keeps the carry of lanes whose condition is false. The port's
loops do the same with explicit masks (one ``.any()`` host sync per
trip), and both branches of a batched ``lax.cond`` are computed and
selected. A finished lane's state never changes. The per-lane pieces with
no control flow (objective, constraints, their derivatives, the block
assembly) are written per lane and batched with ``torch.func.vmap``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev, jvp, vjp, vmap

from pockit_tpu_torch.solver.options import IPOptions

_FILTER_SIZE = 24

# least-squares multiplier init: largest per-lane (m, L) Jacobian that may
# be materialized for the dense normal-equations solve; above this it runs
# matrix-free CG
_LS_INIT_DENSE_MAX_BYTES = 1 << 20

# developer hooks, read once at import as in the JAX package (a solver
# takes the values current when it is built, and ``optimizer.ipm`` caches
# built solvers per system and options):
# POCKIT_IPM_DEBUG_TRACE=1 swaps the per-iteration trace row for
# Newton-direction internals (see body())
_DEBUG_TRACE = os.environ.get("POCKIT_IPM_DEBUG_TRACE", "").strip().lower() not in (
    "", "0", "false", "off", "no",
)
# POCKIT_DUMP_KKT=/path.npz saves the first iteration's assembled
# block-KKT inputs from the kernel path, for offline kernel replay
# (``tools/replay_kkt.py`` reads the file)
_DUMP_KKT = os.environ.get("POCKIT_DUMP_KKT", "").strip()


class Bounds(NamedTuple):
    """NLP bounds: ``z_lb <= z <= z_ub``, ``c_lb <= c(z) <= c_ub``."""

    z_lb: torch.Tensor
    z_ub: torch.Tensor
    c_lb: torch.Tensor
    c_ub: torch.Tensor


def broadcast_bounds(bounds: Bounds, batch_size: int) -> Bounds:
    """Add a leading batch axis to every bounds field."""
    return Bounds(
        *[
            torch.as_tensor(b).expand((batch_size,) + tuple(np.shape(b)))
            for b in bounds
        ]
    )


class IPResult(NamedTuple):
    """Solver output, one row per lane. ``status``: 0 converged, 1
    max-iter, 2 diverged, 3 locally infeasible. ``trace`` holds
    per-iteration [kkt_error, mu, alpha, delta_w, theta, phi] (rows past
    ``iterations`` are zero)."""

    z: torch.Tensor
    s: torch.Tensor  # constraint slacks
    y: torch.Tensor  # constraint multipliers
    obj: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor
    mu: torch.Tensor
    trace: torch.Tensor  # (B, max_iter, 6)


class _State(NamedTuple):
    z: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    w_l: torch.Tensor
    w_u: torch.Tensor
    v_l: torch.Tensor
    v_u: torch.Tensor
    mu: torch.Tensor
    dreg: torch.Tensor  # persistent inertia-regularization level
    th_f: torch.Tensor  # filter theta entries (B, _FILTER_SIZE)
    ph_f: torch.Tensor  # filter phi entries
    trace: torch.Tensor
    rejects: torch.Tensor  # consecutive fully-rejected iterations
    resets: torch.Tensor  # multiplier resets performed
    it: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    kkt: torch.Tensor


def _emit_live_metrics(it, row, finished_prev):
    """Host-side sink for ``IPOptions.live_metrics``, called once per IPM
    trip with the lanes' iteration counters ``it (B,)``, trace rows ``row
    (B, 6)`` and the lanes finished before the trip. One lane prints the
    JAX package's scalar line; more print its batched aggregates over the
    lanes still active."""
    row = np.asarray(row)
    it = np.asarray(it)
    if row.shape[0] == 1:
        kkt, mu, alpha, dw, theta, _ = row[0]
        print(
            f"[ipm] it={int(it[0]):3d} kkt={kkt:9.3e} mu={mu:8.2e} "
            f"alpha={alpha:6.4f} delta_w={dw:8.2e} theta={theta:9.3e}"
        )
    else:
        active = ~np.asarray(finished_prev)
        n_act = int(active.sum())
        if n_act == 0:
            return
        r = row[active]
        print(
            f"[ipm] it~{int(it.max()):3d} active={n_act:5d} "
            f"kkt(max/med)={r[:, 0].max():9.3e}/{np.median(r[:, 0]):9.3e} "
            f"mu(med)={np.median(r[:, 1]):8.2e} "
            f"alpha(med)={np.median(r[:, 2]):6.4f}"
        )


def summarize(trace, iterations=None) -> str:
    """Render one lane's ``IPResult.trace`` as an IPOPT-style table."""
    trace = np.asarray(trace)
    k = int(iterations) if iterations is not None else trace.shape[0]
    lines = ["  it   kkt_error        mu     alpha   delta_w     theta"]
    for i in range(min(k, trace.shape[0])):
        kkt, mu, alpha, dw, theta, _ = trace[i]
        lines.append(
            f"{i:4d}  {kkt:10.3e} {mu:9.2e}  {alpha:8.4f} {dw:9.2e} {theta:9.3e}"
        )
    return "\n".join(lines)


def _sel(mask, new, old):
    """Per-lane select: ``mask (B,)`` broadcast over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


def _select_tree(mask, new, old):
    return type(old)(*[_sel(mask, a, b) for a, b in zip(new, old)])


def _minv(mask, x):
    """Masked reciprocal: 1/x where mask else 0."""
    return torch.where(mask, 1.0 / torch.where(mask, x, 1.0), 0.0)


def _masked_log_sum(mask, x):
    return torch.where(mask, torch.log(torch.where(mask, x, 1.0)), 0.0).sum(-1)


def _amax0(x):
    """Per-lane ``max(x, initial=0)`` (NaN propagates)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return torch.clamp_min(x.amax(-1), 0.0)


def _max_step(mask, x, dx, tau):
    """Fraction-to-boundary: largest alpha in (0, 1] with
    x + alpha*dx >= (1 - tau) * x for masked entries (x > 0)."""
    neg = mask & (dx < 0)
    ratio = torch.where(neg, -tau[:, None] * x / torch.where(neg, dx, -1.0), 1.0)
    if ratio.shape[-1] == 0:
        return ratio.new_ones(ratio.shape[:-1])
    return torch.clamp(ratio.amin(-1), max=1.0)


def _dot(a, b):
    return (a * b).sum(-1)


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``"highest"``: no TF32 in any float32 matmul or convolution for the
    duration (the GPU twin of the reference's bf16 trap); any other value
    allows TF32. The caller's flags are restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    allow = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _check_options(opt: IPOptions):
    if opt.mu_strategy not in ("monotone", "mehrotra", "adaptive"):
        raise ValueError(
            f"unknown mu_strategy {opt.mu_strategy!r}; use 'monotone', "
            "'mehrotra' or 'adaptive'"
        )
    if opt.kkt_solver not in ("auto", "block", "pallas", "dense", "structured"):
        raise ValueError(
            f"unknown kkt_solver {opt.kkt_solver!r}; use 'auto', 'block', "
            "'pallas', 'dense' or 'structured'"
        )


def _dump_kkt(path, **tensors):
    """Save the kernel path's first-iteration inputs as the JAX package's
    ``POCKIT_DUMP_KKT`` file: its keys, its per-lane shapes and padding,
    with the lane axis leading (dropped for a single lane, as the JAX
    package's single solve writes it)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    if arrays["rhs"].shape[0] == 1:
        arrays = {k: v[0] for k, v in arrays.items()}
    np.savez(path, **arrays)


def make_ip_solver(
    f_fn: Callable,
    c_fn: Callable,
    n: int,
    m: int,
    options: IPOptions = IPOptions(),
    structured=None,
    block=None,
):
    """Build ``solve(z0 (B, n), bounds, rt) -> IPResult`` for the NLP

        min f(z, rt)  s.t.  c_lb <= c(z, rt) <= c_ub,  z_lb <= z <= z_ub.

    ``f_fn`` / ``c_fn`` act on ONE lane (``z (n,)``, the lane's ``rt``);
    ``bounds`` fields and ``rt`` leaves carry a leading batch axis.
    ``block`` is a :class:`~pockit_tpu_torch.transcription.kkt.BlockKKT`,
    ``structured`` a :class:`~pockit_tpu_torch.solver.structured.
    StructuredLayout`; ``m == 0`` (no constraints) takes any mode.

    Linear-solver modes (``options.kkt_solver``):

    - ``"pallas"``: the hand-written CUDA kernels of ``solver/cuda_kkt.py``
      (on CPU tensors their plain torch versions), with block-local retries
      and the batched escalation rule of the reference's Pallas path;
      raises ``ValueError`` on a CUDA device for a shape the kernels do not
      take;
    - ``"block"``: the plain block core (``torch.linalg``) with a per-lane
      escalation loop;
    - ``"structured"``: the block core on the block-arrow pattern gathered
      out of a dense condensed ``K`` (an oracle path; needs
      ``structured``);
    - ``"dense"``: a Jacobi-equilibrated dense Cholesky of ``K``;
    - ``"auto"``: with ``block``, the path
      :func:`~pockit_tpu_torch.solver.cuda_kkt.kernel_path` picks from the
      padded shape, dtype and device (the kernels on a CUDA device where
      they take the shape, the block core otherwise); without, ``"dense"``.

    A block-arrow mode without ``block`` and ``"structured"`` without
    ``structured`` take the dense path, as in the reference. The returned
    ``solve`` carries ``solve.kkt_path(dtype, device)``: the path a solve
    of that dtype on that device takes, and ``solve.block_shape``: the
    unpadded ``(nb, ni, nr)`` of the block-arrow layout (``None`` off the
    block paths).
    """
    opt = options
    _check_options(opt)
    debug_trace, dump_kkt = _DEBUG_TRACE, _DUMP_KKT
    mehrotra = opt.mu_strategy == "mehrotra"
    mode = opt.kkt_solver
    use_block = mode in ("auto", "block", "pallas") and block is not None
    use_structured = mode == "structured" and structured is not None

    from pockit_tpu_torch.solver import cuda_kkt
    from pockit_tpu_torch.solver.structured import (
        chol_nan,
        make_block_arrow_core,
        make_pcg_apply,
        make_structured_factor,
    )

    def kkt_path(dtype, device) -> str:
        if use_structured:
            return "structured"
        if not use_block:
            return "dense"
        if mode == "auto":
            return cuda_kkt.kernel_path(block.interior_pad, block.layout.reduced, dtype, device)
        if mode == "pallas" and cuda_kkt.kernel_path(
            block.interior_pad, block.layout.reduced, dtype, device
        ) != "pallas" and torch.device(device).type == "cuda":
            raise ValueError(
                "kkt_solver='pallas': the CUDA kernels do not take this block-arrow "
                f"shape (interior {np.shape(block.interior_pad)[-1]}, reduced "
                f"{len(block.layout.reduced)}) in {dtype}; use 'auto' or 'block'"
            )
        return mode

    if use_block:
        bk_factor, bk_apply = make_block_arrow_core(
            block.interior_pad, block.layout.reduced, n, method=opt.block_core
        )
        bk_krylov = int(block.layout.krylov_rank)
        bk_pcg = make_pcg_apply(bk_apply, bk_krylov + 2) if bk_krylov else None
        interior_t = torch.as_tensor(np.asarray(block.interior_pad, dtype=np.int64))
        reduced_t = torch.as_tensor(np.asarray(block.layout.reduced, dtype=np.int64))
        assemble_b = vmap(block.assemble)
    else:
        bk_krylov = 0
    if use_structured:
        s_factor, s_apply = make_structured_factor(structured)
    cuda_cache = {}

    def _cuda_for(pivot_rtol, delta_w_floor):
        key = (pivot_rtol, delta_w_floor)
        if key not in cuda_cache:
            p_newton, p_apply = cuda_kkt.make_newton_dir(
                block.interior_pad,
                block.layout.reduced,
                n,
                pivot_rtol=pivot_rtol,
                max_reg_tries=opt.max_reg_tries,
                delta_w_floor=delta_w_floor,
                delta_w_max=opt.delta_w_max,
                attempts=opt.pallas_attempts,
                residual_rtol=opt.newton_residual_rtol,
            )
            p_pcg = make_pcg_apply(p_apply, bk_krylov + 2) if bk_krylov else None
            cuda_cache[key] = (p_newton, p_apply, p_pcg)
        return cuda_cache[key]

    # per-lane derivative pieces, batched over lanes; with no constraint
    # rows every constraint-side product is an empty (or zero) tensor
    def _lag(y):
        if not m:
            return f_fn
        return lambda zz, rt: f_fn(zz, rt) + c_fn(zz, rt) @ y

    f_b = vmap(f_fn)
    grad_b = vmap(grad(f_fn))
    if m:
        c_b = vmap(c_fn)
        jac_b = vmap(jacrev(c_fn))
        jmv_b = vmap(lambda z, rt, v: jvp(lambda zz: c_fn(zz, rt), (z,), (v,))[1])
        jtmv_b = vmap(lambda z, rt, u: vjp(lambda zz: c_fn(zz, rt), z)[1](u)[0])
    else:
        c_b = lambda z, rt: z.new_zeros((z.shape[0], 0))
        jac_b = lambda z, rt: z.new_zeros((z.shape[0], 0, n))
        jmv_b = lambda z, rt, v: v.new_zeros((v.shape[0], 0))
        jtmv_b = lambda z, rt, u: z.new_zeros(z.shape)
    lag_grad_b = vmap(lambda z, rt, y: grad(_lag(y))(z, rt))
    wmv_b = vmap(
        lambda z, rt, y, v: jvp(lambda zz: grad(_lag(y))(zz, rt), (z,), (v,))[1]
    )
    # the dense Lagrangian Hessian (forward over reverse, as jax.jacfwd of
    # jax.grad in the reference)
    hess_b = vmap(lambda z, rt, y: jacfwd(grad(_lag(y)))(z, rt))

    # filter-method constants (Wächter & Biegler 2006 defaults)
    GAMMA_TH = 1e-5
    GAMMA_PH = 1e-8
    S_TH = 1.1
    S_PH = 2.3
    DELTA_SW = 1.0
    ETA_PH = 1e-8
    KAPPA_SOC = 0.99

    def solve(z0, bounds: Bounds, rt) -> IPResult:
        with matmul_precision(opt.matmul_precision), torch.no_grad():
            return _solve_impl(z0, bounds, rt)

    solve.kkt_path = kkt_path
    # (nb, ni, nr) of the block-arrow layout the block paths factor, unpadded
    solve.block_shape = (
        (*np.shape(block.interior_pad), len(block.layout.reduced)) if use_block else None
    )

    def _solve_impl(z0, bounds: Bounds, rt) -> IPResult:
        dtype, dev = z0.dtype, z0.device
        B = z0.shape[0]
        # the path is chosen from the shape before any launch; a kernel that
        # fails to build or launch fails the solve (no fallback)
        use_cuda_kkt = kkt_path(dtype, dev) == "pallas"
        eps_dt = float(torch.finfo(dtype).eps)
        pivot_rtol = float(max(opt.chol_pivot_rtol, 2.0 * np.sqrt(eps_dt)))
        delta_c_floor = float(max(opt.delta_c, 100.0 * eps_dt))
        delta_w_floor = float(max(opt.delta_w_init, 10.0 * eps_dt))
        if use_block:
            interior = interior_t.to(dev)
            reduced = reduced_t.to(dev)
        rt = {"bc": tuple(v.to(device=dev, dtype=dtype) for v in rt["bc"])}
        full = lambda v, shape=(B,): torch.full(shape, v, dtype=dtype, device=dev)
        col = lambda a: a[:, None] if torch.is_tensor(a) and a.ndim == 1 else a

        zl, zu, cl, cu = (b.to(device=dev, dtype=dtype) for b in bounds)
        eq = cl == cu
        has_zl, has_zu = torch.isfinite(zl), torch.isfinite(zu)
        has_cl, has_cu = torch.isfinite(cl) & ~eq, torch.isfinite(cu) & ~eq

        # relax inequality bounds slightly so the interior is non-empty,
        # with a dtype-aware floor (f32 zl == zu pins need 64 eps)
        relax = max(opt.bound_relax, 64 * eps_dt)
        zl_r = torch.where(has_zl, zl - relax * torch.clamp_min(zl.abs(), 1.0), zl)
        zu_r = torch.where(has_zu, zu + relax * torch.clamp_min(zu.abs(), 1.0), zu)
        cl_r = torch.where(has_cl, cl - relax * torch.clamp_min(cl.abs(), 1.0), cl)
        cu_r = torch.where(has_cu, cu + relax * torch.clamp_min(cu.abs(), 1.0), cu)

        def _push(val, lo, hi, has_lo, has_hi):
            """Push a point strictly inside its (possibly one-sided) box."""
            k1, k2 = opt.kappa_1, opt.kappa_2
            span = torch.where(has_lo & has_hi, hi - lo, torch.inf)
            p_lo = torch.where(
                has_lo,
                torch.minimum(k1 * torch.clamp_min(lo.abs(), 1.0), k2 * span),
                0.0,
            )
            p_hi = torch.where(
                has_hi,
                torch.minimum(k1 * torch.clamp_min(hi.abs(), 1.0), k2 * span),
                0.0,
            )
            lo_eff = torch.where(has_lo, lo + p_lo, -torch.inf)
            hi_eff = torch.where(has_hi, hi - p_hi, torch.inf)
            return torch.minimum(torch.maximum(val, lo_eff), hi_eff)

        def _bound_gaps(z_, s_):
            return (
                torch.where(has_zl, z_ - zl_r, 1.0),
                torch.where(has_zu, zu_r - z_, 1.0),
                torch.where(has_cl, s_ - cl_r, 1.0),
                torch.where(has_cu, cu_r - s_, 1.0),
            )

        mu0 = full(opt.mu_init)
        z = _push(z0, zl_r, zu_r, has_zl, has_zu)
        c0 = c_b(z, rt)
        s = torch.where(eq, cl, _push(c0, cl_r, cu_r, has_cl, has_cu))
        al0, au0, bl0, bu0 = _bound_gaps(z, s)
        w_l = torch.where(has_zl, col(mu0) / al0, 0.0)
        w_u = torch.where(has_zu, col(mu0) / au0, 0.0)
        v_l = torch.where(has_cl, col(mu0) / bl0, 0.0)
        v_u = torch.where(has_cu, col(mu0) / bu0, 0.0)

        def _ls_multipliers(z_, w_l_, w_u_, g_=None):
            """Least-squares multiplier estimate: minimize ||grad f + J^T y
            - w_l + w_u|| at ``z_``; zero where the estimate is enormous
            or non-finite."""
            g0_ = grad_b(z_, rt) if g_ is None else g_
            r0_ = g0_ - w_l_ + w_u_
            if use_block and m * n * torch.finfo(dtype).bits // 8 > _LS_INIT_DENSE_MAX_BYTES:
                # matrix-free CG on J J^T y = -J r0, fixed trip count
                j0 = lambda v: jmv_b(z_, rt, v)
                jt0 = lambda u: jtmv_b(z_, rt, u)
                b0 = -j0(r0_)
                yv, r_, p_, rr_ = torch.zeros_like(b0), b0, b0, _dot(b0, b0)
                for _ in range(min(m, 128)):
                    Gp = j0(jt0(p_)) + 1e-8 * p_
                    denom = _dot(p_, Gp)
                    alpha = torch.where(denom.abs() > 1e-30, rr_ / denom, 0.0)
                    yv = yv + col(alpha) * p_
                    r_n = r_ - col(alpha) * Gp
                    rr_n = _dot(r_n, r_n)
                    beta = torch.where(rr_ > 1e-30, rr_n / rr_, 0.0)
                    r_, p_, rr_ = r_n, r_n + col(beta) * p_, rr_n
                y0 = yv
            else:
                # materialized normal matrix, Jacobi-PCG with a residual exit
                J0_ = jac_b(z_, rt)
                G = J0_ @ J0_.mT + 1e-8 * torch.eye(m, dtype=dtype, device=dev)
                b0 = -(J0_ @ r0_[:, :, None])[:, :, 0]
                dinv = 1.0 / torch.clamp_min(torch.diagonal(G, dim1=-2, dim2=-1), 1e-30)
                bb = _dot(b0, b0)
                tol_sq = (10.0 * eps_dt) ** 2 * bb
                z0_p = dinv * b0
                yv, r_, p_ = torch.zeros_like(b0), b0, z0_p
                rz_, rr_ = _dot(b0, z0_p), bb
                k_ = torch.zeros((B,), dtype=torch.int32, device=dev)
                while True:
                    run = (rr_ > tol_sq) & (k_ < min(m, 128))
                    if not bool(run.any()):
                        break
                    Gp = (G @ p_[:, :, None])[:, :, 0]
                    denom = _dot(p_, Gp)
                    alpha = torch.where(denom.abs() > 1e-30, rz_ / denom, 0.0)
                    yv_n = yv + col(alpha) * p_
                    r_n = r_ - col(alpha) * Gp
                    z_n = dinv * r_n
                    rz_n = _dot(r_n, z_n)
                    beta = torch.where(rz_.abs() > 1e-30, rz_n / rz_, 0.0)
                    p_n = z_n + col(beta) * p_
                    yv, r_, p_ = _sel(run, yv_n, yv), _sel(run, r_n, r_), _sel(run, p_n, p_)
                    rz_, rr_ = _sel(run, rz_n, rz_), _sel(run, _dot(r_n, r_n), rr_)
                    k_ = k_ + run.to(torch.int32)
                y0 = yv
            # negated <= so a NaN/inf estimate also falls back to zero
            bad = ~(y0.abs().amax(-1) <= 1e3 * torch.clamp_min(g0_.abs().amax(-1), 1.0))
            return _sel(bad, torch.zeros_like(y0), y0)

        theta_init = (c0 - s).abs().sum(-1)
        # LS multiplier init: float64 always; float32 only near-feasible
        # (warm) starts, y0 = 0 otherwise (IPOPT's default)
        if not m:
            y0 = z.new_zeros((B, 0))
        elif eps_dt < 1e-12:
            y0 = _ls_multipliers(z, w_l, w_u)
        else:
            y_ls0 = _ls_multipliers(z, w_l, w_u)
            ls_gate = theta_init <= np.sqrt(eps_dt) * (1.0 + s.abs().sum(-1))
            y0 = _sel(ls_gate, y_ls0, torch.zeros_like(y_ls0))
        theta_min = 1e-4 * torch.clamp_min(theta_init, 1.0)
        theta_max = 1e4 * torch.clamp_min(theta_init, 1.0)

        th_f0 = full(torch.inf, (B, _FILTER_SIZE))
        th_f0[:, 0] = theta_max
        ph_f0 = full(torch.inf, (B, _FILTER_SIZE))
        ph_f0[:, 0] = -torch.inf

        i32 = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
        state = _State(
            z=z, s=s, y=y0, w_l=w_l, w_u=w_u, v_l=v_l, v_u=v_u,
            mu=mu0, dreg=full(0.0), th_f=th_f0, ph_f=ph_f0,
            trace=full(0.0, (B, max(opt.max_iter, 1), 6)),
            rejects=i32(0), resets=i32(0), it=i32(0),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            status=i32(1), kkt=full(torch.inf),
        )
        lanes = torch.arange(B, device=dev)

        def _kkt_error(z, s, y, w_l, w_u, v_l, v_u, g, jty, c0, mu):
            """Scaled KKT error at barrier parameter ``mu`` (IPOPT eq. 5)."""
            mu = col(mu)
            r_stat = g + jty - w_l + w_u
            r_dual_s = torch.where(eq, 0.0, -y - v_l + v_u)
            r_c = c0 - s
            al, au, bl, bu = _bound_gaps(z, s)
            comp = torch.cat(
                [
                    torch.where(has_zl, al * w_l - mu, 0.0),
                    torch.where(has_zu, au * w_u - mu, 0.0),
                    torch.where(has_cl, bl * v_l - mu, 0.0),
                    torch.where(has_cu, bu * v_u - mu, 0.0),
                ],
                -1,
            )
            dual_norm = y.abs().sum(-1) + (w_l + w_u).sum(-1) + (v_l + v_u).sum(-1)
            denom = max(m + 2 * n + 2 * m, 1)
            s_d = torch.clamp_min(dual_norm / denom, opt.s_max) / opt.s_max
            err_stat = _amax0(torch.cat([r_stat.abs(), r_dual_s.abs()], -1))
            err_feas = _amax0(r_c.abs())
            err_comp = _amax0(comp.abs())
            return torch.maximum(torch.maximum(err_stat / s_d, err_feas), err_comp / s_d)

        def _phi_theta(z, s, mu):
            """Barrier objective phi (+inf outside the strict interior) and
            l1 infeasibility theta."""
            f = f_b(z, rt)
            al, au, bl, bu = _bound_gaps(z, s)
            inside = (
                (al > 0).all(-1) & (au > 0).all(-1) & (bl > 0).all(-1) & (bu > 0).all(-1)
            )
            barrier = (
                _masked_log_sum(has_zl, al)
                + _masked_log_sum(has_zu, au)
                + _masked_log_sum(has_cl, bl)
                + _masked_log_sum(has_cu, bu)
            )
            theta = (c_b(z, rt) - s).abs().sum(-1)
            phi = torch.where(inside & torch.isfinite(f), f - mu * barrier, torch.inf)
            return phi, theta

        def body(st: _State) -> _State:
            z, s, y = st.z, st.s, st.y
            w_l, w_u, v_l, v_u = st.w_l, st.w_u, st.v_l, st.v_u
            mu = st.mu

            g = grad_b(z, rt)
            c0 = c_b(z, rt)
            if use_block:
                # matrix-free derivative operators at (z, y): J, J^T, W
                # products; J and W are never built
                j_mv = lambda v: jmv_b(z, rt, v)
                jt_mv = lambda u: jtmv_b(z, rt, u)
                w_mv = lambda v: wmv_b(z, rt, y, v)
                jty = lag_grad_b(z, rt, y) - g
            else:
                # dense per-lane Jacobian and Lagrangian Hessian
                J = jac_b(z, rt)
                W = hess_b(z, rt, y)
                j_mv = lambda v: (J @ v[:, :, None])[:, :, 0]
                jt_mv = lambda u: (J.mT @ u[:, :, None])[:, :, 0]
                jty = jt_mv(y)

            # -- convergence bookkeeping --------------------------------
            E0 = _kkt_error(z, s, y, w_l, w_u, v_l, v_u, g, jty, c0, 0.0)
            newly_done = E0 <= opt.tol
            blown = ~torch.isfinite(E0) | (z.abs().amax(-1) > opt.diverge_threshold)
            # lanes whose step is discarded this iteration never drive the
            # batched escalation or line-search loops
            active = ~(st.done | newly_done | blown)

            # -- barrier update -----------------------------------------
            if opt.mu_strategy == "adaptive":
                # LOQO centrality rule over the bounded entries: mu from
                # the mean and the least complementarity product; lanes
                # with no bounded entry keep theirs; the filter is kept
                al, au, bl, bu = _bound_gaps(z, s)
                has = torch.cat([has_zl, has_zu, has_cl, has_cu], -1)
                comp_v = torch.where(
                    has, torch.cat([al * w_l, au * w_u, bl * v_l, bu * v_u], -1), torch.nan
                )
                valid = ~torch.isnan(comp_v)
                n_comp = valid.sum(-1)
                avg = torch.nansum(comp_v, -1) / torch.clamp_min(n_comp, 1)
                cmin = torch.where(valid, comp_v, torch.inf).amin(-1)
                xi = torch.where(avg > 0, cmin / torch.clamp_min(avg, 1e-30), 1.0)
                sigma = 0.1 * torch.clamp_max(0.05 * (1.0 - xi) / torch.clamp_min(xi, 1e-6), 2.0) ** 3
                mu_ad = torch.clamp(sigma * avg, opt.tol / 10.0, opt.mu_init)
                mu = torch.where(n_comp > 0, mu_ad, mu)
                th_f, ph_f = st.th_f, st.ph_f
            elif mehrotra:
                # mu is retargeted after the affine probe below, which
                # needs this iteration's factorization; the matrix is
                # assembled at the state's mu and the filter is kept
                th_f, ph_f = st.th_f, st.ph_f
            else:
                # monotone ladder; the filter resets with mu
                E_mu = _kkt_error(z, s, y, w_l, w_u, v_l, v_u, g, jty, c0, mu)
                shrink = E_mu <= opt.kappa_eps * mu
                mu = torch.where(
                    shrink,
                    torch.clamp_min(
                        torch.minimum(opt.kappa_mu * mu, mu**opt.theta_mu), opt.tol / 10.0
                    ),
                    mu,
                )
                th_f = _sel(shrink, th_f0, st.th_f)
                ph_f = _sel(shrink, ph_f0, st.ph_f)

            # -- assemble condensed system ------------------------------
            al, au, bl, bu = _bound_gaps(z, s)
            inv_al, inv_au = _minv(has_zl, al), _minv(has_zu, au)
            inv_bl, inv_bu = _minv(has_cl, bl), _minv(has_cu, bu)
            sigma_z = w_l * inv_al + w_u * inv_au
            sigma_s = v_l * inv_bl + v_u * inv_bu
            r_c = c0 - s
            # mu-proportional dual regularization with an absolute floor
            delta_c = torch.clamp_min(opt.delta_c_scale * mu, delta_c_floor)
            D = torch.where(eq, col(1.0 / delta_c), sigma_s)
            mu_c = col(mu)
            g_z = g + jty - mu_c * inv_al + mu_c * inv_au
            g_s = torch.where(eq, 0.0, -y - mu_c * inv_bl + mu_c * inv_bu)
            if mehrotra:
                # the factorization's trial solve probes the affine (mu = 0)
                # system; the centred rhs is re-solved after the probe
                rhs = -(g + jty) - jt_mv(D * r_c + torch.where(eq, 0.0, -y))
            else:
                rhs = -g_z - jt_mv(D * r_c + g_s)

            if use_block:
                # block-arrow assembly from interval-local AD: no (n, n)
                # matrix anywhere
                K_ii0, K_ir0, K_rr0 = assemble_b(z, y, D, rt)
                eye_ni = torch.eye(K_ii0.shape[-1], dtype=dtype, device=dev)
                sig_ext = torch.cat([sigma_z, sigma_z.new_zeros((B, 1))], -1)
                K_ii0 = K_ii0 + eye_ni * sig_ext[:, interior][..., None]
                K_rr0 = K_rr0 + torch.diag_embed(sigma_z[:, reduced])
            else:
                eye_n = torch.eye(n, dtype=dtype, device=dev)
                A_diag = W + torch.diag_embed(sigma_z)
                K0 = A_diag + (J.mT * D[:, None, :]) @ J if m else A_diag
                # (K0 + delta I) v, in the materialized form the factor sees
                k0_mv = lambda v, delta: (
                    (K0 + delta[:, None, None] * eye_n) @ v[:, :, None]
                )[:, :, 0]

            # -- inertia correction -------------------------------------
            step_cap = 1e3 * (1.0 + torch.linalg.vector_norm(z, dim=-1))
            dreg_eff = st.dreg
            if opt.delta_w_min:
                # f32 inertia-detectability floor while globalizing
                theta_pre = r_c.abs().sum(-1)
                dreg_eff = torch.where(
                    theta_pre > theta_min,
                    torch.clamp_min(st.dreg, opt.delta_w_min),
                    st.dreg,
                )

            def kmv(v, delta):
                """True condensed matvec (K + delta I) v, matrix-free."""
                return w_mv(v) + (sigma_z + col(delta)) * v + jt_mv(D * j_mv(v))

            def _pivots_ok(p_min, p_max):
                return torch.isfinite(p_min) & torch.isfinite(p_max) & (p_min > pivot_rtol * p_max)

            if use_cuda_kkt:
                p_newton, p_apply, p_pcg = _cuda_for(pivot_rtol, delta_w_floor)
                if dump_kkt and not os.path.exists(dump_kkt) and not bool(st.it.any()):
                    _dump_kkt(
                        dump_kkt, K_ii=K_ii0, K_ir=K_ir0, K_rr=K_rr0, rhs=rhs,
                        dreg=st.dreg, cap=step_cap, z=z, y=y, D=D, bc=rt["bc"][0],
                    )
                dz, p_fac, delta_w, reg_ok = p_newton(
                    K_ii0, K_ir0, K_rr0, rhs, dreg_eff, step_cap, active
                )

                def chol_solve(b):
                    if not bk_krylov:
                        return p_apply(p_fac, b)
                    return p_pcg(p_fac, b, lambda v: kmv(v, delta_w))

                if bk_krylov:
                    # the escalation validated the preconditioner solve; the
                    # production direction needs the CG correction
                    dz_t = chol_solve(rhs)
                    ok_t = torch.isfinite(dz_t).all(-1) & (
                        torch.linalg.vector_norm(dz_t, dim=-1) <= step_cap
                    )
                    dz = _sel(ok_t & reg_ok, dz_t, dz)
                    reg_ok = reg_ok & ok_t
            else:
                # residual acceptance where the factored operator's matvec is
                # exact: block mode without a low-rank discrepancy, or the
                # dense and structured paths, where K is materialized
                res_check = bool(opt.newton_residual_rtol) and not bk_krylov
                if use_block:
                    eye_nr = torch.eye(K_rr0.shape[-1], dtype=dtype, device=dev)

                    def lin_apply(fac, b):
                        core, delta = fac[:-1], fac[-1]
                        if not bk_krylov:
                            return bk_apply(core, b)
                        return bk_pcg(core, b, lambda v: kmv(v, delta))

                    def lin_factor(delta):
                        K_ii = K_ii0 + eye_ni * delta[:, None, None, None]
                        K_rr = K_rr0 + eye_nr * delta[:, None, None]
                        core, p_min, p_max = bk_factor(K_ii, K_ir0, K_rr)
                        return core + (delta,), _pivots_ok(p_min, p_max)

                    res_mv = kmv
                elif use_structured:

                    def lin_factor(delta):
                        fac, p_min, p_max = s_factor(K0 + delta[:, None, None] * eye_n)
                        return fac, _pivots_ok(p_min, p_max)

                    lin_apply, res_mv = s_apply, k0_mv
                else:

                    def lin_factor(delta):
                        # Jacobi equilibration: K carries a ~1/delta_c spread
                        # between constraint-normal and tangential directions
                        # on its diagonal, which symmetric diagonal scaling
                        # removes; the pivot test sees the scaled conditioning
                        K = K0 + delta[:, None, None] * eye_n
                        sc = torch.rsqrt(torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1), 1e-30))
                        Lc = chol_nan(K * sc[:, :, None] * sc[:, None, :])
                        diag = torch.diagonal(Lc, dim1=-2, dim2=-1)
                        chol_ok = torch.isfinite(diag).all(-1) & (
                            diag.amin(-1) > pivot_rtol * diag.amax(-1)
                        )
                        return (_sel(chol_ok, Lc, eye_n.expand_as(Lc)), sc), chol_ok

                    def lin_apply(fac, b):
                        Lc, sc = fac
                        t = torch.linalg.solve_triangular(Lc, (sc * b)[:, :, None], upper=False)
                        return sc * torch.linalg.solve_triangular(Lc.mT, t, upper=True)[:, :, 0]

                    res_mv = k0_mv

                def _try(delta):
                    fac, chol_ok = lin_factor(delta)
                    dz = lin_apply(fac, rhs)
                    ok = (
                        chol_ok
                        & torch.isfinite(dz).all(-1)
                        & (torch.linalg.vector_norm(dz, dim=-1) <= step_cap)
                    )
                    if res_check:
                        r_fin = rhs - res_mv(dz, delta)
                        ok = ok & (
                            torch.linalg.vector_norm(r_fin, dim=-1)
                            <= opt.newton_residual_rtol
                            * torch.clamp_min(torch.linalg.vector_norm(rhs, dim=-1), 1e-30)
                        )
                    # zero a rejected direction so 0 * nan never reaches z
                    return fac, _sel(ok, dz, torch.zeros_like(dz)), ok

                # per-lane escalation loop (a vmapped lax.while_loop)
                delta_w = st.dreg
                reg_ok = torch.zeros((B,), dtype=torch.bool, device=dev)
                tries = torch.zeros((B,), dtype=torch.int32, device=dev)
                fac_k, dz = None, torch.zeros_like(z)
                while True:
                    run = (~reg_ok) & (tries < opt.max_reg_tries) & active
                    if not bool(run.any()):
                        break
                    delta_new = torch.where(
                        tries == 0,
                        dreg_eff,
                        torch.where(
                            (tries == 1) & (dreg_eff < delta_w_floor),
                            delta_w_floor,
                            torch.clamp(
                                torch.clamp_min(delta_w, delta_w_floor) * 10.0,
                                max=opt.delta_w_max,
                            ),
                        ),
                    )
                    fac_n, dz_n, ok_n = _try(delta_new)
                    fac_k = fac_n if fac_k is None else tuple(
                        _sel(run, a, b) for a, b in zip(fac_n, fac_k)
                    )
                    dz = _sel(run, dz_n, dz)
                    delta_w = _sel(run, delta_new, delta_w)
                    reg_ok = _sel(run, ok_n, reg_ok)
                    tries = tries + run.to(torch.int32)
                if fac_k is None:
                    # no lane active: the step is discarded everywhere
                    fac_k, _, _ = _try(delta_w)

                def chol_solve(b):
                    return lin_apply(fac_k, b)

            if mehrotra:
                # -- Mehrotra probe: measure how much complementarity the
                # affine step would retire, retarget mu by the cubic rule,
                # then solve the centred and corrected rhs against the same
                # factors (one more back-substitution) -----------------
                dz_aff = dz
                ds_a = torch.where(eq, 0.0, j_mv(dz_aff) + r_c)
                dw_l_a = torch.where(has_zl, -w_l - w_l * inv_al * dz_aff, 0.0)
                dw_u_a = torch.where(has_zu, -w_u + w_u * inv_au * dz_aff, 0.0)
                dv_l_a = torch.where(has_cl, -v_l - v_l * inv_bl * ds_a, 0.0)
                dv_u_a = torch.where(has_cu, -v_u + v_u * inv_bu * ds_a, 0.0)
                one = full(1.0)
                a_p = torch.minimum(
                    torch.minimum(
                        _max_step(has_zl, al, dz_aff, one), _max_step(has_zu, au, -dz_aff, one)
                    ),
                    torch.minimum(
                        _max_step(has_cl, bl, ds_a, one), _max_step(has_cu, bu, -ds_a, one)
                    ),
                )
                a_d = torch.minimum(
                    torch.minimum(
                        _max_step(has_zl, w_l, dw_l_a, one), _max_step(has_zu, w_u, dw_u_a, one)
                    ),
                    torch.minimum(
                        _max_step(has_cl, v_l, dv_l_a, one), _max_step(has_cu, v_u, dv_u_a, one)
                    ),
                )

                def _comp(al_, au_, bl_, bu_, wl_, wu_, vl_, vu_):
                    return (
                        torch.where(has_zl, al_ * wl_, 0.0).sum(-1)
                        + torch.where(has_zu, au_ * wu_, 0.0).sum(-1)
                        + torch.where(has_cl, bl_ * vl_, 0.0).sum(-1)
                        + torch.where(has_cu, bu_ * vu_, 0.0).sum(-1)
                    )

                n_comp = has_zl.sum(-1) + has_zu.sum(-1) + has_cl.sum(-1) + has_cu.sum(-1)
                denom = torch.clamp_min(n_comp, 1).to(dtype)
                avg = _comp(al, au, bl, bu, w_l, w_u, v_l, v_u) / denom
                ap, ad = col(a_p), col(a_d)
                mu_aff = _comp(
                    al + ap * dz_aff, au - ap * dz_aff, bl + ap * ds_a, bu - ap * ds_a,
                    w_l + ad * dw_l_a, w_u + ad * dw_u_a, v_l + ad * dv_l_a, v_u + ad * dv_u_a,
                ) / denom
                sigma = torch.clamp((mu_aff / torch.clamp_min(avg, 1e-30)) ** 3, 0.0, 1.0)
                mu_m = torch.clamp(sigma * avg, opt.tol / 10.0, opt.mu_init)
                probe_ok = (
                    (n_comp > 0) & torch.isfinite(mu_m) & reg_ok
                    & torch.isfinite(dz_aff).all(-1)
                )
                mu = torch.where(probe_ok, mu_m, mu)
                mu_c = col(mu)
                # second-order corrector: per-element complementarity
                # targets mu - da_aff * dw_aff, clipped into [0, 10 mu];
                # zeroed where the probe itself is unusable
                corr = col(probe_ok.to(dtype))
                clip = lambda t: torch.minimum(torch.clamp_min(t, 0.0), 10.0 * mu_c)
                t_zl = clip(mu_c - corr * dz_aff * dw_l_a)
                t_zu = clip(mu_c + corr * dz_aff * dw_u_a)
                t_sl = clip(mu_c - corr * ds_a * dv_l_a)
                t_su = clip(mu_c + corr * ds_a * dv_u_a)
                # the centred and corrected direction at the retargeted mu;
                # g_z and g_s are rebound, so the saddle refinement and the
                # dual recovery below target the corrected system
                g_z = g + jty - t_zl * inv_al + t_zu * inv_au
                g_s = torch.where(eq, 0.0, -y - t_sl * inv_bl + t_su * inv_bu)
                rhs = -g_z - jt_mv(D * r_c + g_s)
                dz_c = chol_solve(rhs)
                ok_c = torch.isfinite(dz_c).all(-1) & (
                    torch.linalg.vector_norm(dz_c, dim=-1) <= step_cap
                )
                dz = _sel(ok_c, dz_c, dz)
            else:
                t_zl = t_zu = t_sl = t_su = mu_c

            def _expand(dz_):
                """Recover slack/dual directions from a primal direction."""
                Jdz_ = j_mv(dz_)
                dy_ = D * (Jdz_ + r_c) + g_s
                ds_ = torch.where(eq, 0.0, Jdz_ + r_c)
                return Jdz_, dy_, ds_

            Jdz, dy, ds = _expand(dz)

            if m:
                # saddle-point iterative refinement against the TRUE
                # (unperturbed-delta_c) KKT system, only in the endgame with
                # a numerical-floor delta_w, each correction self-validated.
                # (W + Σ_z) v in its explicit form: K0 v - Jᵀ D J v would
                # cancel the 1/delta_c-scale terms catastrophically in float32
                if use_block:
                    a_mv = lambda v: w_mv(v) + sigma_z * v
                else:
                    a_mv = lambda v: (A_diag @ v[:, :, None])[:, :, 0]
                inv_sig_s = torch.where(
                    eq | (sigma_s <= 0.0), 0.0, 1.0 / torch.where(sigma_s > 0.0, sigma_s, 1.0)
                )
                theta_now = r_c.abs().sum(-1)
                endgame = theta_now <= torch.clamp_min(theta_min, 1e3 * eps_dt)
                numerical_reg = (delta_w <= 100.0 * delta_w_floor) & endgame

                def _saddle_resid(dz_, dy_, Jdz_):
                    r1 = -g_z - a_mv(dz_) - col(delta_w) * dz_ - jt_mv(dy_)
                    r2 = -(r_c + Jdz_) + torch.where(eq, 0.0, (dy_ - g_s) * inv_sig_s)
                    return r1, r2

                rho1, rho2 = _saddle_resid(dz, dy, Jdz)
                res_sq = _dot(rho1, rho1) + _dot(rho2, rho2)
                for _ in range(opt.refine_steps):
                    dzc = chol_solve(rho1 + jt_mv(D * rho2))
                    dyc = D * (j_mv(dzc) - rho2)
                    dz_t = dz + dzc
                    dy_t = dy + dyc
                    Jdz_t = j_mv(dz_t)
                    rho1_t, rho2_t = _saddle_resid(dz_t, dy_t, Jdz_t)
                    res_sq_t = _dot(rho1_t, rho1_t) + _dot(rho2_t, rho2_t)
                    accept = numerical_reg & (res_sq_t < 0.9 * res_sq)
                    dz = _sel(accept, dz_t, dz)
                    dy = _sel(accept, dy_t, dy)
                    Jdz = _sel(accept, Jdz_t, Jdz)
                    rho1 = _sel(accept, rho1_t, rho1)
                    rho2 = _sel(accept, rho2_t, rho2)
                    res_sq = _sel(accept, res_sq_t, res_sq)
                ds = torch.where(eq, 0.0, Jdz + r_c)
            else:
                # no constraint rows: plain iterative refinement of dz
                # against K (less delta_w where it is only a numerical floor)
                numerical_reg = delta_w <= 100.0 * delta_w_floor
                delta_target = torch.where(numerical_reg, 0.0, delta_w)
                if use_block:
                    kref_mv = lambda v: w_mv(v) + (sigma_z + col(delta_target)) * v
                else:
                    kref_mv = lambda v: k0_mv(v, delta_target)
                for _ in range(opt.refine_steps):
                    dz_t = dz - chol_solve(kref_mv(dz) - rhs)
                    dz = _sel(torch.isfinite(dz_t).all(-1), dz_t, dz)

            dy_cap = 1e3 * (1.0 + _amax0(y.abs()))
            dy_norm = _amax0(dy.abs())
            dy = dy * col(torch.clamp(dy_cap / torch.clamp_min(dy_norm, 1e-30), max=1.0))
            # t_* are the per-element complementarity targets: mu for the
            # monotone rule, the clipped corrector targets for Mehrotra
            dw_l = torch.where(has_zl, t_zl * inv_al - w_l - w_l * inv_al * dz, 0.0)
            dw_u = torch.where(has_zu, t_zu * inv_au - w_u + w_u * inv_au * dz, 0.0)
            dv_l = torch.where(has_cl, t_sl * inv_bl - v_l - v_l * inv_bl * ds, 0.0)
            dv_u = torch.where(has_cu, t_su * inv_bu - v_u + v_u * inv_bu * ds, 0.0)

            # -- fraction to boundary -----------------------------------
            tau = torch.clamp_min(1.0 - mu, opt.tau_min)

            def _ftb_primal(dz_, ds_):
                return torch.minimum(
                    torch.minimum(
                        _max_step(has_zl, al, dz_, tau), _max_step(has_zu, au, -dz_, tau)
                    ),
                    torch.minimum(
                        _max_step(has_cl, bl, ds_, tau), _max_step(has_cu, bu, -ds_, tau)
                    ),
                )

            a_pri_max = _ftb_primal(dz, ds)
            a_dual = torch.minimum(
                torch.minimum(
                    _max_step(has_zl, w_l, dw_l, tau), _max_step(has_zu, w_u, dw_u, tau)
                ),
                torch.minimum(
                    _max_step(has_cl, v_l, dv_l, tau), _max_step(has_cu, v_u, dv_u, tau)
                ),
            )

            # -- filter line search (Wächter-Biegler) -------------------
            phi0, theta0 = _phi_theta(z, s, mu)
            dphi = _dot(g - mu_c * inv_al + mu_c * inv_au, dz) + _dot(
                -mu_c * inv_bl + mu_c * inv_bu, ds
            )

            def _acceptable(alpha, th_t, ph_t):
                filter_ok = (
                    (col(th_t) <= (1.0 - GAMMA_TH) * th_f)
                    | (col(ph_t) <= ph_f - GAMMA_PH * th_f)
                ).all(-1)
                switching = (
                    (dphi < 0)
                    & (
                        alpha * dphi.abs() ** S_PH
                        > DELTA_SW * torch.clamp_min(theta0, 1e-30) ** S_TH
                    )
                    & (theta0 <= theta_min)
                )
                armijo = ph_t <= phi0 + ETA_PH * alpha * dphi
                suff = (th_t <= (1.0 - GAMMA_TH) * theta0) | (
                    ph_t <= phi0 - GAMMA_PH * theta0
                )
                return filter_ok & torch.where(switching, armijo, suff), switching

            def _trial(alpha, dz_, ds_):
                ph_t, th_t = _phi_theta(z + col(alpha) * dz_, s + col(alpha) * ds_, mu)
                acc, sw = _acceptable(alpha, th_t, ph_t)
                return ph_t, th_t, acc, sw

            ph_1, th_1, acc_1, sw_1 = _trial(a_pri_max, dz, ds)

            # second-order correction on a rejected full step that did not
            # reduce infeasibility (re-using the factors); both branches of
            # the reference's batched cond, computed only if a lane wants it
            soc_wanted = (~acc_1) & (th_1 >= theta0) & opt.soc
            soc_good = torch.zeros_like(acc_1)
            a_soc, dz_soc, ds_soc, sw_soc = full(1.0), dz, ds, torch.zeros_like(acc_1)
            if opt.soc and m and bool(soc_wanted.any()):
                z_t = z + col(a_pri_max) * dz
                c_t = c_b(z_t, rt)
                s_t = s + col(a_pri_max) * ds
                r_soc = torch.where(eq, c_t - cl, c_t - s_t)
                dz_cor = chol_solve(-jt_mv(D * r_soc))
                dz_soc = col(a_pri_max) * dz + dz_cor
                _, _, ds_soc = _expand(dz_soc)
                a_soc = _ftb_primal(dz_soc, ds_soc)
                ph_s, th_s = _phi_theta(z + col(a_soc) * dz_soc, s + col(a_soc) * ds_soc, mu)
                acc_s, sw_soc = _acceptable(a_soc, th_s, ph_s)
                soc_good = acc_s & (th_s <= KAPPA_SOC * theta0) & soc_wanted

            # backtracking on the original direction
            alpha_bt, acc_bt = a_pri_max, acc_1 | soc_good
            sw_bt = torch.zeros_like(acc_1)
            k_ls = torch.zeros((B,), dtype=torch.int32, device=dev)
            while True:
                run = (~acc_bt) & (k_ls < opt.max_ls) & active
                if not bool(run.any()):
                    break
                alpha_n = alpha_bt * 0.5
                _, _, acc_n, sw_n = _trial(alpha_n, dz, ds)
                alpha_bt = _sel(run, alpha_n, alpha_bt)
                acc_bt = _sel(run, acc_n, acc_bt)
                sw_bt = _sel(run, sw_n, sw_bt)
                k_ls = k_ls + run.to(torch.int32)

            # select the step: SOC > first trial > backtracked > rejected
            use_soc = soc_good
            use_first = acc_1
            accepted = acc_1 | soc_good | acc_bt
            alpha = torch.where(use_first, a_pri_max, torch.where(use_soc, a_soc, alpha_bt))
            dz_eff = _sel(use_soc & ~use_first, dz_soc, dz)
            ds_eff = _sel(use_soc & ~use_first, ds_soc, ds)
            sw_eff = torch.where(use_first, sw_1, torch.where(use_soc, sw_soc, sw_bt))

            # -- feasibility fallback: a damped Gauss-Newton step on the
            # constraint violation when every trial failed. Only an active
            # lane that was not accepted can take it, so it is computed
            # only when one exists.
            use_fb = torch.zeros_like(accepted)
            if opt.feasibility_fallback and bool(((~accepted) & active).any()):
                dz_fb = chol_solve(-jt_mv(D * r_c)) if m else torch.zeros_like(dz)
                _, _, ds_fb = _expand(dz_fb)
                a_fb_max = _ftb_primal(dz_fb, ds_fb)
                a_fb = a_fb_max
                fb_ok = accepted | (theta0 <= 1e-14)
                k_fb = torch.zeros((B,), dtype=torch.int32, device=dev)
                while True:
                    run = (~fb_ok) & (k_fb < opt.max_ls) & active
                    if not bool(run.any()):
                        break
                    alpha_f = torch.where(k_fb == 0, a_fb_max, a_fb * 0.5)
                    ph_t, th_t = _phi_theta(
                        z + col(alpha_f) * dz_fb, s + col(alpha_f) * ds_fb, mu
                    )
                    ok_n = (th_t < (1.0 - GAMMA_TH * 0.1) * theta0) & torch.isfinite(ph_t)
                    a_fb = _sel(run, alpha_f, a_fb)
                    fb_ok = _sel(run, ok_n, fb_ok)
                    k_fb = k_fb + run.to(torch.int32)
                use_fb = (~accepted) & fb_ok & (theta0 > 1e-14)
                alpha = torch.where(use_fb, a_fb, alpha)
                dz_eff = _sel(use_fb, dz_fb, dz_eff)
                ds_eff = _sel(use_fb, ds_fb, ds_eff)
            alpha = torch.where(use_fb | accepted, alpha, 0.0)
            took_step = accepted | use_fb

            # filter augmentation for h-type (non-Armijo) accepted steps;
            # slot 0 holds the theta_max cap and is never evicted
            augment = took_step & ~(sw_eff & ~use_fb)
            score = torch.where(torch.isinf(th_f) & (th_f > 0), torch.inf, th_f)
            score[:, 0] = -torch.inf
            idx = score.argmax(-1)
            th_aug = th_f.clone()
            ph_aug = ph_f.clone()
            th_aug[lanes, idx] = (1.0 - GAMMA_TH) * theta0
            ph_aug[lanes, idx] = phi0 - GAMMA_PH * theta0
            th_f_new = _sel(augment, th_aug, th_f)
            ph_f_new = _sel(augment, ph_aug, ph_f)

            # -- apply the step -----------------------------------------
            dy_eff = _sel(use_fb, torch.zeros_like(dy), dy)
            z_n = z + col(alpha) * dz_eff
            s_n = s + col(alpha) * ds_eff
            y_n = y + col(alpha) * dy_eff
            # slack correction: a float32 step can round exactly onto a
            # bound; push strictly inside by an eps-relative margin
            d_zb = eps_dt * (1.0 + z_n.abs())
            d_zb = torch.where(has_zl & has_zu, torch.minimum(d_zb, 0.25 * (zu_r - zl_r)), d_zb)
            z_n = torch.where(has_zl, torch.maximum(z_n, zl_r + d_zb), z_n)
            z_n = torch.where(has_zu, torch.minimum(z_n, zu_r - d_zb), z_n)
            d_sb = eps_dt * (1.0 + s_n.abs())
            d_sb = torch.where(has_cl & has_cu, torch.minimum(d_sb, 0.25 * (cu_r - cl_r)), d_sb)
            s_n = torch.where(has_cl & ~eq, torch.maximum(s_n, cl_r + d_sb), s_n)
            s_n = torch.where(has_cu & ~eq, torch.minimum(s_n, cu_r - d_sb), s_n)
            a_dual_eff = col(torch.where(took_step & ~use_fb, a_dual, 0.0))
            w_l_n = w_l + a_dual_eff * dw_l
            w_u_n = w_u + a_dual_eff * dw_u
            v_l_n = v_l + a_dual_eff * dv_l
            v_u_n = v_u + a_dual_eff * dv_u

            # dual safeguard (keeps Sigma bounded relative to mu / primal)
            kap = 1e10
            al_n, au_n, bl_n, bu_n = _bound_gaps(z_n, s_n)
            clip = lambda w, a: torch.minimum(torch.maximum(w, mu_c / (kap * a)), kap * mu_c / a)
            w_l_n = torch.where(has_zl, clip(w_l_n, al_n), 0.0)
            w_u_n = torch.where(has_zu, clip(w_u_n, au_n), 0.0)
            v_l_n = torch.where(has_cl, clip(v_l_n, bl_n), 0.0)
            v_u_n = torch.where(has_cu, clip(v_u_n, bu_n), 0.0)

            rejects_n = torch.where(took_step, 0, st.rejects + 1).to(torch.int32)
            do_reset = rejects_n >= 5
            # a second stall after a multiplier reset with significant
            # violation indicates local infeasibility
            infeasible = do_reset & (st.resets >= 1) & (theta0 > 1e3 * opt.tol)
            resets_n = st.resets + do_reset.to(torch.int32)
            y_n = _sel(do_reset, torch.zeros_like(y_n), y_n)
            dr = col(do_reset)
            w_l_n = torch.where(dr & has_zl, mu_c / al_n, w_l_n)
            w_u_n = torch.where(dr & has_zu, mu_c / au_n, w_u_n)
            v_l_n = torch.where(dr & has_cl, mu_c / bl_n, v_l_n)
            v_u_n = torch.where(dr & has_cu, mu_c / bu_n, v_u_n)
            th_f_new = _sel(do_reset, th_f0, th_f_new)
            ph_f_new = _sel(do_reset, ph_f0, ph_f_new)
            rejects_n = torch.where(do_reset, 0, rejects_n).to(torch.int32)

            # regularization memory, Levenberg-Marquardt style
            newton_ok = accepted & reg_ok
            dreg_n = torch.where(
                newton_ok,
                torch.where(delta_w / 3.0 < delta_w_floor, 0.0, delta_w / 3.0),
                torch.clamp(torch.clamp_min(delta_w, delta_w_floor) * 10.0, max=opt.delta_w_max),
            )
            dreg_n = torch.where(do_reset, 0.0, dreg_n)

            if debug_trace:
                # diagnostic mode (POCKIT_IPM_DEBUG_TRACE=1): record Newton
                # direction internals [|rhs|, max|K|, |dz|, max|dz|,
                # delta_w, step_cap] instead of the standard row
                K_abs = K_ii0.abs().amax((-3, -2, -1)) if use_block else K0.abs().amax((-2, -1))
                trace_row = torch.stack(
                    [
                        torch.linalg.vector_norm(rhs, dim=-1),
                        K_abs,
                        torch.linalg.vector_norm(dz, dim=-1),
                        dz.abs().amax(-1),
                        delta_w,
                        step_cap,
                    ],
                    -1,
                )
            else:
                trace_row = torch.stack([E0, mu, alpha, delta_w, theta0, phi0], -1)
            trace_n = st.trace.clone()
            trace_n[lanes, st.it.clamp(max=st.trace.shape[1] - 1).long()] = trace_row
            if opt.live_metrics:
                _emit_live_metrics(
                    st.it.cpu().numpy(), trace_row.cpu().numpy(), st.done.cpu().numpy()
                )

            # freeze finished lanes, record status transitions
            finished = st.done | newly_done | blown | infeasible
            status = torch.where(
                newly_done, 0, torch.where(blown, 2, torch.where(infeasible, 3, st.status))
            )
            new = _State(
                z=z_n, s=s_n, y=y_n, w_l=w_l_n, w_u=w_u_n, v_l=v_l_n, v_u=v_u_n,
                mu=mu, dreg=dreg_n, th_f=th_f_new, ph_f=ph_f_new, trace=trace_n,
                rejects=rejects_n, resets=resets_n, it=st.it + 1, done=finished,
                status=status.to(torch.int32), kkt=E0,
            )
            out = _select_tree(finished, st, new)
            return out._replace(
                done=finished,
                status=_sel(st.done, st.status, new.status),
                kkt=_sel(st.done, st.kkt, E0),
            )

        st = state
        while True:
            run = (~st.done) & (st.it < opt.max_iter)
            if not bool(run.any()):
                break
            with torch.profiler.record_function("ipm.iteration"):
                st = _select_tree(run, body(st), st)

        # final KKT error for reporting (J^T y via one vjp), then the
        # post-loop dual refresh: a fresh least-squares y accepted per lane
        # only where it strictly improves the measured KKT error
        g = grad_b(st.z, rt)
        c0 = c_b(st.z, rt)
        jty_f = jtmv_b(st.z, rt, st.y)
        kkt = _kkt_error(st.z, st.s, st.y, st.w_l, st.w_u, st.v_l, st.v_u, g, jty_f, c0, 0.0)
        y_fin = st.y
        if m:
            y_ls = _ls_multipliers(st.z, st.w_l, st.w_u, g_=g)
            kkt_ls = _kkt_error(
                st.z, st.s, y_ls, st.w_l, st.w_u, st.v_l, st.v_u, g,
                jtmv_b(st.z, rt, y_ls), c0, 0.0,
            )
            better = kkt_ls < kkt
            y_fin = _sel(better, y_ls, st.y)
            kkt = torch.where(better, kkt_ls, kkt)
        status = torch.where(kkt <= opt.tol, 0, st.status).to(torch.int32)
        return IPResult(
            z=st.z,
            s=st.s,
            y=y_fin,
            obj=f_b(st.z, rt),
            status=status,
            iterations=st.it,
            kkt_error=kkt,
            mu=st.mu,
            trace=st.trace,
        )

    return solve
