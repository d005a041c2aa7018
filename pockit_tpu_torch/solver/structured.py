"""Block-arrow layout and the plain batched block-arrow factorization.

The port of ``pockit_tpu/solver/structured.py``: the static layout
(:func:`structured_layout`, numpy/sympy), the pairwise summation the
kernels keep (:func:`_tree_sum`), the block-arrow core
(:func:`make_block_arrow_core`) on either primitive set: "lax" (batched
``torch.linalg.cholesky_ex`` / ``solve_triangular``) or "unrolled" (the
reference's left-looking elementwise Cholesky and substitutions, with
8-wide panels from 33 up), the pattern-preconditioned CG
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


def _tree_reduce(t, dim):
    """Sum ``t`` over ``dim`` in :func:`_tree_sum`'s pairwise order, by
    elementwise adds of strided halves only: no reduction kernel, so each
    output's rounding is independent of every other axis's size."""
    t = t.movedim(dim, 0)
    while t.shape[0] > 1:
        n = t.shape[0]
        half = t[0 : n - 1 : 2] + t[1:n:2]
        t = torch.cat([half, t[n - 1 :]]) if n % 2 else half
    return t[0]


# largest elementwise product a tree dot materializes at once; bigger ones
# are cut along their leading axis (the lanes), which no lane's order sees
_TREE_DOT_BYTES = 1 << 28


def _tree_dot(a, b, dim):
    """``_tree_reduce(a * b, dim)`` (``a`` and ``b`` broadcast, ``dim``
    negative), its product made a slice of the leading axis at a time."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    nbytes = int(np.prod(shape)) * a.element_size()
    if nbytes <= _TREE_DOT_BYTES or len(shape) + dim < 1 or shape[0] == 1:
        return _tree_reduce(a * b, dim)
    a, b = a.expand(shape), b.expand(shape)
    step = max(1, shape[0] * _TREE_DOT_BYTES // nbytes)
    return torch.cat(
        [_tree_reduce(a[i : i + step] * b[i : i + step], dim) for i in range(0, shape[0], step)]
    )


def _chol_unrolled(A):
    """Left-looking Cholesky of an ``(..., k, k)`` batch, column by column
    in elementwise ops, as the reference's ``_chol_unrolled``: column j is
    ``A[j:, j]`` (the lower triangle only, no symmetrization) less the
    tree sum over earlier columns p of ``L[j:, p] * L[j, p]``, divided by
    the square root of its first entry. A negative pivot surfaces as nan
    (and every later column with it). Elementwise arithmetic makes each
    lane's bits independent of the batch's shape."""
    k = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(k):
        a = A[..., j:, j]
        if j:
            a = a - _tree_dot(L[..., j:, :j], L[..., j : j + 1, :j], -1)
        L[..., j:, j] = a / torch.sqrt(a[..., :1])
    return L


def _tri_solve_unrolled(L, B, lower=True):
    """Solve ``L x = B`` (``lower``) or ``L^T x = B`` (pass the lower factor)
    for ``L (..., k, k)``, ``B (..., k, m)`` by substitution, row by row,
    each row's dot over the solved rows tree-summed in index order (the
    reference's ``_tri_solve_unrolled``)."""
    k = L.shape[-1]
    X = torch.empty_like(B)
    for i in range(k) if lower else range(k - 1, -1, -1):
        s = B[..., i, :]
        done = slice(0, i) if lower else slice(i + 1, k)
        if (lower and i) or (not lower and i < k - 1):
            coef = L[..., i, done] if lower else L[..., done, i]
            s = s - _tree_dot(coef[..., :, None], X[..., done, :], -2)
        X[..., i, :] = s / L[..., i, i, None]
    return X


# panel width of the blocked forms; blocks of _BLOCKED_MIN and wider use
# them (the reference's constants: its fully unrolled trace at the
# Goddard's 60 and the orbit's 126 was too large to compile)
_BLOCKED_PANEL = 8
_BLOCKED_MIN = 33


def _chol_blocked(A):
    """Left-looking blocked Cholesky (the reference's ``_chol_blocked``):
    per 8-wide panel, the correction against every factored column (a
    tree sum over those columns, elementwise, where the reference runs
    one matmul), the panel's diagonal block by :func:`_chol_unrolled`, and
    the rows below it by :func:`_tri_solve_unrolled`."""
    k = A.shape[-1]
    P = _BLOCKED_PANEL
    if k <= P:
        return _chol_unrolled(A)
    L = torch.zeros_like(A)
    for p0 in range(0, k, P):
        p1 = min(p0 + P, k)
        C = A[..., p0:, p0:p1]
        if p0:
            C = C - _tree_dot(L[..., p0:, None, :p0], L[..., None, p0:p1, :p0], -1)
        Ld = _chol_unrolled(C[..., : p1 - p0, :])
        L[..., p0:p1, p0:p1] = Ld
        if p1 < k:
            # X Ld^T = T  <=>  Ld X^T = T^T
            L[..., p1:, p0:p1] = _tri_solve_unrolled(Ld, C[..., p1 - p0 :, :].mT, lower=True).mT
    return L


def _tri_solve_blocked(L, B, lower=True):
    """Blocked companion of :func:`_chol_blocked` (the reference's
    ``_tri_solve_blocked``): per 8-row panel, the correction against the
    solved panels as a tree sum, then :func:`_tri_solve_unrolled`."""
    k = L.shape[-1]
    P = _BLOCKED_PANEL
    if k <= P:
        return _tri_solve_unrolled(L, B, lower=lower)
    bounds = [(p0, min(p0 + P, k)) for p0 in range(0, k, P)]
    X = torch.empty_like(B)
    for p0, p1 in bounds if lower else reversed(bounds):
        rhs = B[..., p0:p1, :]
        if lower and p0:
            rhs = rhs - _tree_dot(L[..., p0:p1, :p0, None], X[..., None, :p0, :], -2)
        elif not lower and p1 < k:
            rhs = rhs - _tree_dot(L[..., p1:, p0:p1].mT[..., None], X[..., None, p1:, :], -2)
        X[..., p0:p1, :] = _tri_solve_unrolled(L[..., p0:p1, p0:p1], rhs, lower=lower)
    return X


def chol_unrolled(A):
    """The unrolled core's Cholesky: :func:`_chol_blocked` from
    ``_BLOCKED_MIN`` columns up, :func:`_chol_unrolled` below."""
    return _chol_blocked(A) if A.shape[-1] >= _BLOCKED_MIN else _chol_unrolled(A)


def tri_solve_unrolled(L, B, lower=True):
    """The unrolled core's triangular solve (blocked from ``_BLOCKED_MIN``)."""
    if L.shape[-1] >= _BLOCKED_MIN:
        return _tri_solve_blocked(L, B, lower=lower)
    return _tri_solve_unrolled(L, B, lower=lower)


def chol_nan(A):
    """Batched Cholesky of the symmetrized ``(A + A^T) / 2``, as
    ``jnp.linalg.cholesky`` factors by default, that reports a failure as
    NaN factors (as it does) instead of raising. An equilibrated block
    ``K * sc[:, None] * sc[None, :]`` is symmetric only to rounding, and in
    float32 near its conditioning limit the average of both triangles gives
    a markedly better solve than the lower triangle alone."""
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


class _Primitives(NamedTuple):
    """One block core's factor, triangular solve and the three contractions
    of the block-arrow elimination (over leading batch axes)."""

    chol: object  # A (..., k, k) -> L, nan on a failed pivot
    tri: object  # (L, B, lower) -> L^{-1} B or L^{-T} B
    schur: object  # (K_ir (..., nb, ni, nr), X_ir) -> sum_bi K_ir^T X_ir (..., nr, nr)
    down: object  # (K_ir, x_bi (..., nb, ni)) -> sum_bi K_ir^T x_bi (..., nr)
    up: object  # (X_ir, x_r (..., nr)) -> X_ir x_r (..., nb, ni)


def _lax_tri(L, B, lower):
    return torch.linalg.solve_triangular(L if lower else L.mT, B, upper=not lower)


def _flat_bi(t):
    """``(..., nb, ni, r) -> (..., nb * ni, r)``: the unrolled contractions
    tree-sum over the interval blocks' rows in one flat index order."""
    return t.reshape(t.shape[:-3] + (-1, t.shape[-1]))


_LAX = _Primitives(
    chol=chol_nan,
    tri=_lax_tri,
    schur=lambda K_ir, X_ir: torch.einsum("...bik,...bil->...kl", K_ir, X_ir),
    down=lambda K_ir, x_bi: torch.einsum("...bik,...bi->...k", K_ir, x_bi),
    up=lambda X_ir, x_r: torch.einsum("...bik,...k->...bi", X_ir, x_r),
)
_UNROLLED = _Primitives(
    chol=chol_unrolled,
    tri=tri_solve_unrolled,
    schur=lambda K_ir, X_ir: _tree_dot(
        _flat_bi(K_ir)[..., :, :, None], _flat_bi(X_ir)[..., :, None, :], -3
    ),
    down=lambda K_ir, x_bi: _tree_dot(_flat_bi(K_ir), x_bi.flatten(-2)[..., None], -2),
    up=lambda X_ir, x_r: _tree_dot(X_ir, x_r[..., None, None, :], -1),
)


def _primitives(method: str) -> _Primitives:
    """The block core of ``method``. "auto" is "lax" on every device: the
    reference's "unrolled" exists because TPU XLA's Cholesky and triangular
    solve expanders changed a lane's numerics with the batch shape, and
    LAPACK and cuSOLVER have no such expander; phase 11c of
    ``chip_smoke.py`` prints both cores' batch invariance on the card, the
    evidence any change of this default needs."""
    if method not in ("auto", "lax", "unrolled"):
        raise ValueError(
            f"unknown block_core method {method!r}; use 'auto', 'lax' or "
            "'unrolled'"
        )
    return _UNROLLED if method == "unrolled" else _LAX


def make_block_arrow_core(interior, reduced, n: int, method: str = "auto"):
    """Factor/apply for a block-arrow SPD system in block storage
    ``(K_ii (..., nb, ni, ni), K_ir (..., nb, ni, nr), K_rr (..., nr, nr))``.

    - ``factor(K_ii, K_ir, K_rr) -> (factors, pivot_min, pivot_max)``:
      Jacobi-equilibrated batched Cholesky of every interior, then the
      reduced Schur complement; a failed factorization reports NaN pivot
      extrema (as ``jnp.linalg.cholesky`` does), never raises.
    - ``apply(factors, rhs (..., n)) -> x (..., n)``.

    ``method``: "lax" factors with ``torch.linalg`` (the symmetrized
    :func:`chol_nan`); "unrolled" with the reference's elementwise forms
    (:func:`chol_unrolled`, :func:`tri_solve_unrolled`, tree-summed
    contractions), which give every lane the same bits at any batch shape;
    "auto" is "lax" (see :func:`_primitives`).
    """
    prim = _primitives(method)
    interior_t = torch.as_tensor(np.asarray(interior, dtype=np.int64))
    reduced_t = torch.as_tensor(np.asarray(reduced, dtype=np.int64))

    def _blk_solve(L_i, sc_i, B):
        Bs = B * sc_i[..., :, None]
        t = prim.tri(L_i, Bs, True)
        X = prim.tri(L_i, t, False)
        return X * sc_i[..., :, None]

    def factor(K_ii, K_ir, K_rr):
        eye_i = torch.eye(K_ii.shape[-1], dtype=K_ii.dtype, device=K_ii.device)
        eye_r = torch.eye(K_rr.shape[-1], dtype=K_ii.dtype, device=K_ii.device)
        sc_i = torch.rsqrt(
            torch.clamp_min(torch.diagonal(K_ii, dim1=-2, dim2=-1), 1e-30)
        )
        K_ii_t = K_ii * sc_i[..., :, None] * sc_i[..., None, :]
        L_i = prim.chol(K_ii_t)
        diag_i = torch.diagonal(L_i, dim1=-2, dim2=-1)
        L_i_safe = torch.where(torch.isfinite(L_i), L_i, eye_i)
        X_ir = _blk_solve(L_i_safe, sc_i, K_ir)  # K_ii^{-1} K_ir

        S = K_rr - prim.schur(K_ir, X_ir)
        sc_r = torch.rsqrt(torch.clamp_min(torch.diagonal(S, dim1=-2, dim2=-1), 1e-30))
        S_t = S * sc_r[..., :, None] * sc_r[..., None, :]
        L_r = prim.chol(S_t)
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
        r_red = b_r - prim.down(K_ir, x_bi)
        t = prim.tri(L_r, (sc_r * r_red)[..., None], True)
        x_r = sc_r * prim.tri(L_r, t, False)[..., 0]
        x_i = x_bi - prim.up(X_ir, x_r)
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

    ``method``: the block core of :func:`make_block_arrow_core` ("lax",
    "unrolled", or "auto", which is "lax"); the JAX solve uses no Pallas
    kernel here.
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
    prim = _primitives(method)
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
        t = prim.tri(L_i, Bs, True)
        X = prim.tri(L_i, t, False)
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
        L_i = prim.chol(K_ii * sc_i[:, :, None] * sc_i[:, None, :])
        X_ir = _blk_solve(L_i, sc_i, K_ir)
        x_bi = _blk_solve(L_i, sc_i, b_i[:, :, None])[:, :, 0]

        # partial Schur contributions; ONE all_reduce pair crosses ranks
        S_part = prim.schur(K_ir, X_ir)
        r_part = prim.down(K_ir, x_bi)
        dist.all_reduce(S_part, group=group)
        dist.all_reduce(r_part, group=group)
        S = K[reduced[:, None], reduced[None, :]] - S_part
        r_red = rhs[reduced] - r_part

        sc_r = torch.rsqrt(torch.clamp_min(torch.diagonal(S), 1e-30))
        L_r = prim.chol(S * sc_r[:, None] * sc_r[None, :])
        t = prim.tri(L_r, (sc_r * r_red)[:, None], True)
        x_r = sc_r * prim.tri(L_r, t, False)[:, 0]

        x_i = x_bi - prim.up(X_ir, x_r)
        x_local = torch.zeros_like(rhs)
        x_local[my_interior.reshape(-1)] = x_i.reshape(-1)
        # sum the ranks' interior pieces; add the (replicated) reduced part once
        dist.all_reduce(x_local, group=group)
        x = x_local.index_put((reduced,), x_r)
        return x[:n]

    return solve
