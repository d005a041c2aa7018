"""Native interior-point solve of a configured system.

The port of ``pockit_tpu/optimizer/ipm.py``, with the same calling
convention:

    [var_phase, var_static], info = ipm.solve(system, [guess_phase, guess_s])

``solve_batch`` and ``solve_batch_drained`` solve many instances of one
discretized system at once. Tensors keep the device and dtype they are
given; numpy inputs go to ``device`` (default ``"cuda"``: pass
``device="cpu"`` for the CPU) in ``dtype`` (default
``torch.get_default_dtype()``, the port's counterpart of JAX's x64 flag).
Asking for CUDA where there is no card raises PyTorch's own error: nothing
moves to the CPU unasked.

``solve_batch`` and the first pass of ``solve_batch_drained`` run a batch
artifact installed for their options (``utils.aot.install_batch_solver``),
and each drain round runs an installed drain-round artifact
(``install_drain_round``); neither needs the frontend, so a system loaded
from artifacts (``utils.aot.ArtifactSystem``) solves through them with no
``System`` built.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from pockit_tpu_torch.solver import Bounds, IPOptions, broadcast_bounds, make_ip_solver
from pockit_tpu_torch.utils.profiling import span

if TYPE_CHECKING:
    from pockit_tpu_torch.base.system import SystemBase

_STATUS_MSG = {
    0: b"Solve Succeeded (KKT error below tolerance).",
    1: b"Maximum number of iterations reached.",
    2: b"Iterates diverged.",
    3: b"Problem appears locally infeasible (restoration stalled).",
}


def default_options(dtype=None) -> IPOptions:
    """Tolerance-scaled default options: 1e-8 in float64, 2e-5 in float32."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    if dtype == torch.float64:
        return IPOptions(tol=1e-8)
    return IPOptions(tol=2e-5)


def solver_cache(compiled) -> dict:
    """The compiled system's cache: built solvers keyed by options, and the
    installed artifacts keyed by ``(options, "batch")`` and ``(options,
    "drain_round")``."""
    cache = getattr(compiled, "_ipm_cache", None)
    if cache is None:
        cache = {}
        compiled._ipm_cache = cache
    return cache


def kkt_parts(system: SystemBase, options: IPOptions):
    """``(structured, block)``: what the solver for ``options`` factors.
    ``"structured"`` and the block-arrow modes fall back to the dense path
    (both ``None``), with a warning, on a degenerate mesh that has no
    interval-interior column; ``"auto"`` takes it without one."""
    structured = None
    block = None
    if options.kkt_solver == "structured":
        from pockit_tpu_torch.solver.structured import structured_layout

        structured = structured_layout(system)
        if structured is None:
            warnings.warn(
                "structured KKT solver requested but the problem has "
                "no interval-interior columns (degenerate tiny mesh); "
                "falling back to the dense solver"
            )
    elif options.kkt_solver in ("auto", "block", "pallas"):
        from pockit_tpu_torch.transcription.kkt import make_block_kkt

        block = make_block_kkt(system)
        if block is None and options.kkt_solver != "auto":
            warnings.warn(
                f"{options.kkt_solver} KKT solver requested but the "
                "problem has no interval-interior columns (degenerate "
                "tiny mesh); falling back to the dense solver"
            )
    return structured, block


def _solver_for(system: SystemBase, options: IPOptions):
    """The built solver for ``options``, cached on the compiled system."""
    compiled = system.compiled
    cache = solver_cache(compiled)
    if options not in cache:
        if getattr(compiled, "from_artifacts", False):
            raise ValueError(
                "a system loaded from solver artifacts solves only through "
                f"the artifacts installed on it; none is installed for {options}"
            )
        structured, block = kkt_parts(system, options)
        cache[options] = make_ip_solver(
            compiled.objective_fn,
            compiled.constraints_fn,
            compiled.L,
            compiled.m,
            options,
            structured=structured,
            block=block,
        )
    bounds = Bounds(
        *(
            torch.as_tensor(np.asarray(b, dtype=np.float64))
            for b in (compiled.z_lb, compiled.z_ub, compiled.c_lb, compiled.c_ub)
        )
    )
    return compiled, cache[options], bounds


def _as_batch(guess_batch, device, dtype):
    if isinstance(guess_batch, torch.Tensor):
        return guess_batch.to(
            device=device or guess_batch.device, dtype=dtype or guess_batch.dtype
        )
    return torch.as_tensor(
        np.asarray(guess_batch),
        dtype=dtype or torch.get_default_dtype(),
        device=device or "cuda",
    )


def _bc_batch(compiled, bc_overrides, B, device, dtype):
    if bc_overrides is None:
        return tuple(
            v.expand(B, -1) for v in compiled.default_runtime(device, dtype)["bc"]
        )
    return tuple(torch.as_tensor(v, device=device, dtype=dtype) for v in bc_overrides)


def solve(
    system: SystemBase,
    guess,
    optimizer_options: Optional[IPOptions] = None,
    *,
    device="cuda",
    dtype=None,
):
    """Solve the system with the native interior-point method.

    Args:
        system: fully configured ``System``.
        guess: a single ``Variable`` (one phase, no statics) or a list of
            per-phase ``Variable`` s followed by the static-parameter array.
        optimizer_options: an :class:`IPOptions`; ``None`` uses
            dtype-appropriate defaults.
        device, dtype: where and in which precision to solve (the card
            unless ``device="cpu"``).

    Returns:
        ``(result, info)`` where ``result`` matches the shape of ``guess``
        and ``info`` is a dict with ``status``, ``status_msg``, ``obj_val``,
        ``iterations``, ``kkt_error``, ``mu``, ``kkt_solver`` (the KKT path
        taken), ``mult_c``, ``x``, ``trace``.
    """
    from pockit_tpu_torch.optimizer._common import postprocess, preprocess

    dtype = dtype or torch.get_default_dtype()
    x_0, guess_is_variable = preprocess(system, guess)
    res = solve_batch(
        system, x_0[None], optimizer_options=optimizer_options,
        device=device, dtype=dtype,
    )
    x = res.z[0].to(torch.float64).cpu().numpy()
    Variable = type(guess) if guess_is_variable else type(guess[0])
    out = postprocess(Variable, system, x, guess_is_variable)
    iterations = int(res.iterations[0])
    _, solve_fn, _ = _solver_for(system, optimizer_options or default_options(dtype))
    info = {
        "status": int(res.status[0]),
        "status_msg": _STATUS_MSG.get(int(res.status[0]), b"Unknown."),
        "obj_val": float(res.obj[0]),
        "iterations": iterations,
        "kkt_error": float(res.kkt_error[0]),
        "mu": float(res.mu[0]),
        # the KKT path the solve took ("pallas" is the CUDA kernels)
        "kkt_solver": solve_fn.kkt_path(res.z.dtype, res.z.device),
        "mult_c": res.y[0].cpu().numpy(),
        "x": x,
        # per-iteration metrics [kkt, mu, alpha, delta_w, theta, phi]
        "trace": res.trace[0].cpu().numpy()[:iterations],
    }
    return out, info


def solve_batch(
    system: SystemBase,
    guess_batch,
    bc_overrides=None,
    optimizer_options: Optional[IPOptions] = None,
    bounds_override: Optional[Bounds] = None,
    *,
    device=None,
    dtype=None,
):
    """Solve a batch of instances of the same discretized system.

    All instances share the NLP structure; per-instance data varies through
    the initial guesses ``guess_batch (B, L)``, the FIXED boundary values
    ``bc_overrides`` (one ``(B, n_fixed)`` array per phase) and optionally
    the bounds (a ``Bounds`` with leading batch axes). A batch artifact
    installed for ``optimizer_options`` runs instead of the built solver;
    its bounds are baked in, so it takes no ``bounds_override``.

    Returns a batched :class:`IPResult` on the guesses' device.
    """
    z0 = _as_batch(guess_batch, device, dtype)
    B = z0.shape[0]
    if optimizer_options is None:
        optimizer_options = default_options(z0.dtype)
    compiled = system.compiled
    rt = {"bc": _bc_batch(compiled, bc_overrides, B, z0.device, z0.dtype)}
    installed = solver_cache(compiled).get((optimizer_options, "batch"))
    if installed is not None:
        if bounds_override is not None:
            raise ValueError("an installed batch artifact has its bounds baked in")
        return installed(z0, *rt["bc"])
    _, solve_fn, bounds0 = _solver_for(system, optimizer_options)
    bounds = broadcast_bounds(bounds0, B) if bounds_override is None else bounds_override
    return solve_fn(z0, bounds, rt)


def make_drain_round(solve_fn, bounds_d: Bounds):
    """``drain_round(z_full, idx, *bc_full) -> (z_full', packed)``: gather
    the rows ``idx`` of ``z_full`` and of each boundary-value batch, solve
    them with ``solve_fn`` and ``bounds_d``, scatter the solutions back, and
    stack (status, obj, iterations) into ``packed (3, B_drain)`` for one
    host fetch."""

    def drain_round(z, idx, *bc):
        r = solve_fn(z[idx], bounds_d, {"bc": tuple(v[idx] for v in bc)})
        pk = torch.stack([r.status.to(r.obj.dtype), r.obj, r.iterations.to(r.obj.dtype)])
        # duplicate indices (np.resize tiling) write identical rows
        return z.index_put((idx,), r.z), pk

    return drain_round


def solve_batch_drained(
    system: SystemBase,
    guess_batch,
    bc_overrides=None,
    optimizer_options: Optional[IPOptions] = None,
    first_pass_iters: int = 8,
    drain_frac: int = 8,
    max_drain_rounds: int = 4,
    first_pass_options: Optional[IPOptions] = None,
    return_first_pass_mask: bool = False,
    *,
    device=None,
    dtype=None,
):
    """Batched solve with straggler draining.

    A short-iteration first pass over the full batch, then the unconverged
    lanes are gathered into a compact ``B // drain_frac`` batch (indices
    tiled by ``np.resize`` to fill it), solved, and written back, for up to
    ``max_drain_rounds`` rounds. A drain-round artifact installed for
    ``optimizer_options`` runs each round in place of the built solver.
    Returns ``(status, obj, iterations, z)``: host numpy arrays and ``z`` on
    the solve's device.
    """
    z0 = _as_batch(guess_batch, device, dtype)
    if optimizer_options is None:
        optimizer_options = default_options(z0.dtype)
    opts_fast = first_pass_options or dataclasses.replace(
        optimizer_options, max_iter=first_pass_iters
    )
    B = z0.shape[0]
    B_drain = max(B // drain_frac, 8)

    res = solve_batch(system, z0, bc_overrides=bc_overrides, optimizer_options=opts_fast)
    # one packed device-to-host copy for (status, obj, iterations)
    packed = (
        torch.stack([res.status.to(res.obj.dtype), res.obj, res.iterations.to(res.obj.dtype)])
        .cpu()
        .numpy()
    )
    status = packed[0].astype(np.int32)
    obj = packed[1].copy()
    iters = packed[2].astype(np.int64)
    z = res.z
    first_pass_mask = status == 0

    compiled = system.compiled
    drain_round = solver_cache(compiled).get((optimizer_options, "drain_round"))
    if drain_round is None:
        _, solve_fn_d, bounds0 = _solver_for(system, optimizer_options)
        drain_round = make_drain_round(solve_fn_d, broadcast_bounds(bounds0, B_drain))

    bc_full = _bc_batch(compiled, bc_overrides, B, z.device, z.dtype)
    pending = np.where(status != 0)[0]
    rounds = 0
    while len(pending) and rounds < max_drain_rounds:
        take = pending[:B_drain]
        with span("ipm.drain_round"):
            idx = torch.as_tensor(np.resize(take, B_drain), device=z.device)
            z, pk = drain_round(z, idx, *bc_full)
            pk = pk.cpu().numpy()
        uniq = len(take)
        status[take] = pk[0, :uniq].astype(np.int32)
        obj[take] = pk[1, :uniq]
        iters[take] = iters[take] + pk[2, :uniq].astype(np.int64)
        pending = pending[uniq:]
        rounds += 1
    if return_first_pass_mask:
        return status, obj, iters, z, first_pass_mask
    return status, obj, iters, z
