"""Block-arrow layout and the plain batched block-arrow factorization.

The port of ``pockit_tpu/solver/structured.py``: the static layout
(:func:`structured_layout`, numpy/sympy), the pairwise summation the
kernels keep (:func:`_tree_sum`), the LAPACK-backed block-arrow core
(:func:`make_block_arrow_core`, batched ``torch.linalg.cholesky_ex`` /
``solve_triangular``), the pattern-preconditioned CG
(:func:`make_pcg_apply`), the dense-K entry points of the
``kkt_solver="structured"`` oracle path (:func:`make_structured_factor`,
:func:`make_structured_solve`, :func:`pattern_violation`), and the solve of
one instance with its interiors spread over the ranks of a mesh axis
(:func:`make_sharded_structured_solve`).

The condensed interior-point matrix of a collocation NLP is block-arrow:
interval interiors are mutually disjoint and only borders, times and
statics (the "reduced" columns) couple globally, so

    S = K_rr - Σ_i K_ri K_ii^{-1} K_ir

is the only dense factorization left after eliminating every interior in
parallel. All functions here take any number of leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import sympy as sp
import torch


class StructuredLayout(NamedTuple):
    """Static index layout of the block-arrow pattern.

    ``krylov_rank`` counts the dense low-rank coupling OUTSIDE the pattern
    (system-constraint rows, nonlinear-in-integral objective terms): 0 means
    the pattern is exact and one factor/apply pass solves K; r > 0 means
    the pattern factorization preconditions r + 2 CG steps.

    Ragged interiors are padded at the END of each row with the PHANTOM
    column ``n_cols``: gathers read a zero-extended vector, scatters drop
    it, and the assembled blocks carry 1.0 on padded diagonal slots.
    """

    interior: np.ndarray  # (n_blocks, ni_max) global column indices, padded
    reduced: np.ndarray  # (n_red,) global column indices (borders + arrow)
    krylov_rank: int = 0
    n_cols: int = 0  # total real columns; doubles as the phantom index


def structured_layout(system) -> Optional[StructuredLayout]:
    """Compute the block-arrow layout of a compiled system's KKT matrix
    (identical to ``pockit_tpu.solver.structured.structured_layout``).
    Returns ``None`` when there is no interior column at all."""
    krylov_rank = 0
    all_I = [I_sym for p in system.p for I_sym in p.I]
    s_syms = list(system.s)
    exprs = [sp.sympify(system._expr_objective)] + [
        sp.sympify(c) for c in system.expr_system_constraint
    ]
    I_involved = set()
    s_coupled = set()
    for e in exprs:
        for ia, a in enumerate(all_I):
            for b in all_I[ia:]:
                if sp.diff(e, a, b) != 0:
                    I_involved.add(a)
                    I_involved.add(b)
            for sk in s_syms:
                if sp.diff(e, a, sk) != 0:
                    I_involved.add(a)
                    s_coupled.add(sk)
    krylov_rank += len(I_involved) + len(s_coupled)
    krylov_rank += system.n_c  # dense system-constraint Jacobian rows

    interior_blocks = []
    reduced = []
    for pi, p in enumerate(system.p):
        d = p.d
        off = int(system.l_p[pi])
        per_interval = [[] for _ in range(d.N)]
        for v in range(p.n):
            base = off + int(d.l_v[v])
            is_state = v < p.n_x
            if d.family == "lobatto" or is_state:
                l_idx, r_idx = (d.l_x, d.r_x) if is_state else (d.l_u, d.r_u)
                if d.family == "lobatto":
                    l_idx, r_idx = d.l_m, d.r_m
                borders = set()
                for i in range(d.N):
                    borders.add(int(l_idx[i]))
                    borders.add(int(r_idx[i]) - 1)
                for i in range(d.N):
                    for k in range(int(l_idx[i]), int(r_idx[i])):
                        if k in borders:
                            continue
                        per_interval[i].append(base + k)
                reduced.extend(base + k for k in sorted(borders))
            else:
                for i in range(d.N):
                    for k in range(int(d.l_u[i]), int(d.r_u[i])):
                        per_interval[i].append(base + k)
        reduced.extend([off + d.L - 2, off + d.L - 1])
        interior_blocks.extend(per_interval)

    reduced.extend(range(int(system.l_s), int(system.r_s)))

    L = int(system.L)
    ni_max = max((len(b) for b in interior_blocks), default=0)
    if ni_max == 0:
        return None
    interior = np.full((len(interior_blocks), ni_max), L, dtype=np.int32)
    for k, b in enumerate(interior_blocks):
        interior[k, : len(b)] = b
    reduced = np.array(sorted(reduced), dtype=np.int32)
    real = interior[interior < L]
    all_idx = np.concatenate([real, reduced])
    if len(np.unique(all_idx)) != L or len(all_idx) != L:
        return None
    return StructuredLayout(
        interior=interior, reduced=reduced, krylov_rank=krylov_rank, n_cols=L
    )


def pattern_violation(K, layout: StructuredLayout) -> float:
    """Largest ``|K|`` entry outside the block-arrow pattern of ``layout``
    (an oracle check: about 0 where the structured solve is exact). ``K``
    is ``(n, n)``, numpy or a tensor."""
    K = torch.as_tensor(K)
    n = K.shape[-1]
    owner = torch.full((n + 1,), -1, dtype=torch.int64)
    for b, cols in enumerate(np.asarray(layout.interior)):
        owner[torch.as_tensor(cols.astype(np.int64))] = b
    owner = owner[:n]  # phantom slots of ragged layouts land in the extra slot
    in_reduced = torch.zeros((n,), dtype=torch.bool)
    in_reduced[torch.as_tensor(np.asarray(layout.reduced, dtype=np.int64))] = True
    ow_i, ow_j = owner[:, None], owner[None, :]
    allowed = in_reduced[:, None] | in_reduced[None, :] | ((ow_i == ow_j) & (ow_i >= 0))
    return float(torch.where(allowed.to(K.device), 0.0, K.abs()).max())


def _tree_sum(terms):
    """Pairwise summation (log-depth rounding instead of linear), in the
    exact order of the reference's ``_tree_sum``; the CUDA kernels sum in
    the same order."""
    while len(terms) > 1:
        odd = [terms[-1]] if len(terms) % 2 else []
        terms = [
            terms[2 * j] + terms[2 * j + 1] for j in range(len(terms) // 2)
        ] + odd
    return terms[0]


def _dot(a, b):
    return (a * b).sum(-1)


def gather_blocks(x, interior, reduced):
    """Split ``x (..., n)`` into interiors ``(..., nb, ni)`` (phantom slots
    read 0) and the reduced part ``(..., nr)``."""
    x_ext = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    return x_ext[..., interior], x[..., reduced]


def scatter_blocks(x_i, x_r, interior, reduced, n):
    """Inverse of :func:`gather_blocks`: place interiors and the reduced
    part into ``(..., n)``; phantom slots land in a dropped extra column."""
    lead = x_r.shape[:-1]
    out = x_r.new_zeros(lead + (n + 1,))
    out[..., interior.reshape(-1)] = x_i.reshape(lead + (-1,))
    out[..., reduced] = x_r
    return out[..., :n]


def block_arrow_mv(K_ii, K_ir, K_rr, d_int, d_red, x, interior, reduced):
    """Block-arrow matvec ``(K + D) x`` on batch-leading blocks, ``x (B,
    n)``, with per-block diagonal shifts ``d_int (B, nb)`` on the interiors
    and ``d_red (B,)`` on the reduced block."""
    x_i, x_r = gather_blocks(x, interior, reduced)
    y_i = (
        torch.einsum("...kij,...kj->...ki", K_ii, x_i)
        + torch.einsum("...kij,...j->...ki", K_ir, x_r)
        + d_int[..., None] * x_i
    )
    y_r = (
        torch.einsum("...kij,...ki->...j", K_ir, x_i)
        + torch.einsum("...ij,...j->...i", K_rr, x_r)
        + d_red[..., None] * x_r
    )
    return scatter_blocks(y_i, y_r, interior, reduced, x.shape[-1])


def chol_nan(A):
    """Batched Cholesky of the symmetrized ``(A + A^T) / 2``, as
    ``jnp.linalg.cholesky`` factors by default, that reports a failure as
    NaN factors (as it does) instead of raising. An equilibrated block
    ``K * sc[:, None] * sc[None, :]`` is symmetric only to rounding, and in
    float32 near its conditioning limit the average of both triangles gives
    a markedly better solve than the lower triangle alone."""
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def make_block_arrow_core(interior, reduced, n: int, method: str = "auto"):
    """Factor/apply for a block-arrow SPD system in block storage
    ``(K_ii (..., nb, ni, ni), K_ir (..., nb, ni, nr), K_rr (..., nr, nr))``.

    - ``factor(K_ii, K_ir, K_rr) -> (factors, pivot_min, pivot_max)``:
      Jacobi-equilibrated batched Cholesky of every interior, then the
      reduced Schur complement; a failed factorization reports NaN pivot
      extrema (as ``jnp.linalg.cholesky`` does), never raises.
    - ``apply(factors, rhs (..., n)) -> x (..., n)``.

    ``method`` accepts the reference's values; "auto" and "lax" mean
    LAPACK/cuSOLVER-backed ``torch.linalg``. "unrolled" (an expander-free
    form that only the TPU needed) is not ported.
    """
    if method not in ("auto", "lax", "unrolled"):
        raise ValueError(
            f"unknown block_core method {method!r}; use 'auto', 'lax' or "
            "'unrolled'"
        )
    if method == "unrolled":
        raise NotImplementedError(
            "block_core='unrolled' works around TPU XLA expanders and is "
            "not ported (ROADMAP queue 1, left out on purpose)"
        )
    interior_t = torch.as_tensor(np.asarray(interior, dtype=np.int64))
    reduced_t = torch.as_tensor(np.asarray(reduced, dtype=np.int64))

    def _blk_solve(L_i, sc_i, B):
        Bs = B * sc_i[..., :, None]
        t = torch.linalg.solve_triangular(L_i, Bs, upper=False)
        X = torch.linalg.solve_triangular(L_i.mT, t, upper=True)
        return X * sc_i[..., :, None]

    def factor(K_ii, K_ir, K_rr):
        eye_i = torch.eye(K_ii.shape[-1], dtype=K_ii.dtype, device=K_ii.device)
        eye_r = torch.eye(K_rr.shape[-1], dtype=K_ii.dtype, device=K_ii.device)
        sc_i = torch.rsqrt(
            torch.clamp_min(torch.diagonal(K_ii, dim1=-2, dim2=-1), 1e-30)
        )
        K_ii_t = K_ii * sc_i[..., :, None] * sc_i[..., None, :]
        L_i = chol_nan(K_ii_t)
        diag_i = torch.diagonal(L_i, dim1=-2, dim2=-1)
        L_i_safe = torch.where(torch.isfinite(L_i), L_i, eye_i)
        X_ir = _blk_solve(L_i_safe, sc_i, K_ir)  # K_ii^{-1} K_ir

        S = K_rr - torch.einsum("...bik,...bil->...kl", K_ir, X_ir)
        sc_r = torch.rsqrt(torch.clamp_min(torch.diagonal(S, dim1=-2, dim2=-1), 1e-30))
        S_t = S * sc_r[..., :, None] * sc_r[..., None, :]
        L_r = chol_nan(S_t)
        diag_r = torch.diagonal(L_r, dim1=-2, dim2=-1)
        L_r_safe = torch.where(torch.isfinite(L_r), L_r, eye_r)

        pivots = torch.cat([diag_i.flatten(-2), diag_r], dim=-1)
        finite = torch.isfinite(pivots).all(-1)
        p_min = torch.where(finite, pivots.amin(-1), torch.nan)
        p_max = torch.where(finite, pivots.amax(-1), torch.nan)
        factors = (L_i_safe, sc_i, X_ir, K_ir, L_r_safe, sc_r)
        return factors, p_min, p_max

    def apply(factors, rhs):
        L_i, sc_i, X_ir, K_ir, L_r, sc_r = factors
        b_i, b_r = gather_blocks(rhs, interior_t.to(rhs.device), reduced_t.to(rhs.device))
        x_bi = _blk_solve(L_i, sc_i, b_i[..., None])[..., 0]
        r_red = b_r - torch.einsum("...bik,...bi->...k", K_ir, x_bi)
        t = torch.linalg.solve_triangular(
            L_r, (sc_r * r_red)[..., None], upper=False
        )
        x_r = sc_r * torch.linalg.solve_triangular(L_r.mT, t, upper=True)[..., 0]
        x_i = x_bi - torch.einsum("...bik,...k->...bi", X_ir, x_r)
        return scatter_blocks(
            x_i, x_r, interior_t.to(rhs.device), reduced_t.to(rhs.device), n
        )

    return factor, apply


def make_pcg_apply(apply, n_steps: int):
    """Pattern-preconditioned CG with an EXTERNAL matvec: solves
    ``K x = rhs`` (rows of a batch) where ``K`` differs from the factored
    pattern by a rank-r term; callers pass ``n_steps = r + 2``."""

    def apply_cg(factors, rhs, matvec):
        x = apply(factors, rhs)
        r = rhs - matvec(x)
        z = apply(factors, r)
        p = z
        rz = _dot(r, z)
        for _ in range(n_steps):
            Kp = matvec(p)
            denom = _dot(p, Kp)
            alpha = torch.where(denom.abs() > 1e-30, rz / denom, 0.0)
            x = x + alpha[..., None] * p
            r = r - alpha[..., None] * Kp
            z = apply(factors, r)
            rz_new = _dot(r, z)
            beta = torch.where(rz.abs() > 1e-30, rz_new / rz, 0.0)
            p = z + beta[..., None] * p
            rz = rz_new
        return x

    return apply_cg


def make_structured_factor(layout: StructuredLayout):
    """Dense-K entry point of the ``kkt_solver="structured"`` oracle path:
    gather the block-arrow pattern out of a condensed ``K (..., n, n)`` and
    factor it with :func:`make_block_arrow_core`. The block path assembles
    the blocks directly and never forms ``K``.

    Returns ``(factor, apply)``: ``factor(K) -> (factors, pivot_min,
    pivot_max)`` and ``apply(factors, rhs (..., n)) -> x``. Phantom slots of
    a ragged layout read 0 and get unit pivots. When ``layout.krylov_rank >
    0`` the pattern is not exact and ``apply`` runs ``krylov_rank + 2``
    steps of CG against ``K`` with the pattern factorization as
    preconditioner.
    """
    interior_np = np.asarray(layout.interior, dtype=np.int64)
    reduced_np = np.asarray(layout.reduced, dtype=np.int64)
    n = int(layout.n_cols) or int(interior_np.size + reduced_np.size)
    pad_mask = interior_np >= n
    has_pad = bool(pad_mask.any())
    core_factor, core_apply = make_block_arrow_core(interior_np, reduced_np, n)
    interior = torch.as_tensor(interior_np)
    reduced = torch.as_tensor(reduced_np)
    pad = torch.as_tensor(pad_mask)

    def factor(K):
        idx_i, idx_r = interior.to(K.device), reduced.to(K.device)
        # phantom gathers read the zero row and column appended here
        K_ext = torch.nn.functional.pad(K, (0, 1, 0, 1)) if has_pad else K
        K_ii = K_ext[..., idx_i[:, :, None], idx_i[:, None, :]]  # (..., nb, ni, ni)
        K_ir = K_ext[..., idx_i[:, :, None], idx_r[None, None, :]]  # (..., nb, ni, nr)
        K_rr = K[..., idx_r[:, None], idx_r[None, :]]  # (..., nr, nr)
        if has_pad:
            eye = torch.eye(K_ii.shape[-1], dtype=K.dtype, device=K.device)
            K_ii = K_ii + eye * pad.to(device=K.device, dtype=K.dtype)[:, :, None]
        factors, p_min, p_max = core_factor(K_ii, K_ir, K_rr)
        return factors + (K,), p_min, p_max

    def apply(factors, rhs):
        """One pattern solve (exact when ``krylov_rank == 0``)."""
        return core_apply(factors[:-1], rhs)

    if layout.krylov_rank == 0:
        return factor, apply

    # the full K differs from its pattern by a rank-r term: CG with the
    # pattern factorization as preconditioner removes it in r + 1 steps
    # (r + 2 for rounding headroom)
    apply_cg = make_pcg_apply(apply, int(layout.krylov_rank) + 2)

    def apply_pcg(factors, rhs):
        K = factors[-1]
        return apply_cg(factors, rhs, lambda v: (K @ v[..., None])[..., 0])

    return factor, apply_pcg


def make_structured_solve(layout: StructuredLayout):
    """One-shot ``solve(K, rhs) -> (x, pivot_min, pivot_max)`` over
    :func:`make_structured_factor`."""
    factor, apply = make_structured_factor(layout)

    def solve(K, rhs):
        factors, p_min, p_max = factor(K)
        return apply(factors, rhs), p_min, p_max

    return solve


def make_sharded_structured_solve(
    layout: StructuredLayout, mesh, axis: str, method: str = "auto"
):
    """Time-axis-sharded structured solve over the ``axis`` of a
    ``DeviceMesh``: ``solve(K (n, n), rhs (n,)) -> x``.

    The interval-interior blocks are independent, so they shard over the
    ranks of ``axis``: each rank gathers and factors its own interiors (one
    small batched Cholesky), one ``all_reduce`` pair sums the reduced Schur
    contributions (an ``n_red x n_red`` matrix and a vector), the small
    border + arrow system is solved on every rank alike, and one more
    ``all_reduce`` sums the back-substituted interiors. ``K`` and ``rhs``
    enter replicated, and every rank returns the whole ``x``. The number of
    interior blocks must be divisible by the axis size; exact for
    ``krylov_rank == 0`` layouts.

    ``method``: "auto" and "lax" factor with ``torch.linalg`` (the JAX
    solve uses no Pallas kernel here); "unrolled" (an expander-free form
    that only the TPU needed) is not ported.
    """
    import torch.distributed as dist

    nb, ni = layout.interior.shape
    n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
    if nb % n_dev:
        raise ValueError(f"{nb} interior blocks not divisible by {n_dev} devices")
    if layout.krylov_rank:
        raise ValueError(
            "sharded structured solve requires an exact block-arrow pattern"
        )
    if method not in ("auto", "lax", "unrolled"):
        raise ValueError(
            f"unknown method {method!r}; use 'auto', 'lax' or 'unrolled'"
        )
    if method == "unrolled":
        raise NotImplementedError(
            "method='unrolled' works around TPU XLA expanders and is not "
            "ported (ROADMAP queue 1, left out on purpose)"
        )
    group = mesh.get_group(axis)
    interior_np = np.asarray(layout.interior, dtype=np.int64)
    L_cols = int(layout.n_cols) or int(interior_np.size + layout.reduced.size)
    has_pad = bool((interior_np >= L_cols).any())
    my_interior_np = interior_np.reshape(n_dev, nb // n_dev, ni)[mesh.get_local_rank(axis)]
    my_interior_t = torch.as_tensor(my_interior_np)
    reduced_t = torch.as_tensor(np.asarray(layout.reduced, dtype=np.int64))
    pad_t = torch.as_tensor(my_interior_np >= L_cols)

    def _blk_solve(L_i, sc_i, B):
        Bs = B * sc_i[:, :, None]
        t = torch.linalg.solve_triangular(L_i, Bs, upper=False)
        X = torch.linalg.solve_triangular(L_i.mT, t, upper=True)
        return X * sc_i[:, :, None]

    def solve(K, rhs):
        dev = K.device
        my_interior, reduced = my_interior_t.to(dev), reduced_t.to(dev)
        n = rhs.shape[0]
        if has_pad:
            # zero-extend by one phantom row and column (the layout's
            # phantom index is n_cols): phantom gathers read 0 where JAX
            # would clamp, and phantom scatters land in the extra slot
            K = torch.nn.functional.pad(K, (0, 1, 0, 1))
            rhs = torch.nn.functional.pad(rhs, (0, 1))
        K_ii = K[my_interior[:, :, None], my_interior[:, None, :]]
        K_ir = K[my_interior[:, :, None], reduced[None, None, :]]
        b_i = rhs[my_interior]
        if has_pad:
            # padded slots need the unit pivot before equilibration (a zero
            # diagonal would nan the Cholesky)
            pad = pad_t.to(device=dev, dtype=K.dtype)
            K_ii = K_ii + torch.eye(ni, dtype=K.dtype, device=dev) * pad[:, :, None]

        sc_i = torch.rsqrt(
            torch.clamp_min(torch.diagonal(K_ii, dim1=1, dim2=2), 1e-30)
        )
        L_i = chol_nan(K_ii * sc_i[:, :, None] * sc_i[:, None, :])
        X_ir = _blk_solve(L_i, sc_i, K_ir)
        x_bi = _blk_solve(L_i, sc_i, b_i[:, :, None])[:, :, 0]

        # partial Schur contributions; ONE all_reduce pair crosses ranks
        S_part = torch.einsum("bik,bil->kl", K_ir, X_ir)
        r_part = torch.einsum("bik,bi->k", K_ir, x_bi)
        dist.all_reduce(S_part, group=group)
        dist.all_reduce(r_part, group=group)
        S = K[reduced[:, None], reduced[None, :]] - S_part
        r_red = rhs[reduced] - r_part

        sc_r = torch.rsqrt(torch.clamp_min(torch.diagonal(S), 1e-30))
        L_r = chol_nan(S * sc_r[:, None] * sc_r[None, :])
        t = torch.linalg.solve_triangular(L_r, (sc_r * r_red)[:, None], upper=False)
        x_r = sc_r * torch.linalg.solve_triangular(L_r.mT, t, upper=True)[:, 0]

        x_i = x_bi - torch.einsum("bik,k->bi", X_ir, x_r)
        x_local = torch.zeros_like(rhs)
        x_local[my_interior.reshape(-1)] = x_i.reshape(-1)
        # sum the ranks' interior pieces; add the (replicated) reduced part once
        dist.all_reduce(x_local, group=group)
        x = x_local.index_put((reduced,), x_r)
        return x[:n]

    return solve
