"""Block-arrow KKT factorization and back-solves as hand-written CUDA
kernels, with their plain batched torch versions beside them.

The port of ``pockit_tpu/solver/pallas_kkt.py``. Three kernels
(``csrc/block_arrow_kkt.cu``) replace its three Pallas kernels:

- :func:`factor_blocks` (``_factor_kernel``): per interval block, the
  per-lane base delta on the diagonal, Jacobi equilibration, a
  left-looking Cholesky with tree-summed dots, pivot extrema over the real
  rows, the in-kernel retry ladder and block-local acceptance; then
  ``X_ir = K_ii^{-1} K_ir`` and the Schur complement in Gram form, and
  finally the reduced block's factorization;
- :func:`apply_down` (``_apply_down_kernel``): the interior solves and the
  reduced right-hand side;
- :func:`apply_up` (``_apply_up_kernel``): the reduced solve and the
  interior back-substitution.

Every array is in the reference's padded batch-LAST layout (lanes
trailing, lanes padded to a multiple of 128, rows padded to multiples of
8 with unit diagonals; see :func:`KKTCore.pad_move`). A wrapper given CPU
tensors runs the plain version (``*_ref``), which computes exactly what
the Pallas body computes, in the same summation order; given CUDA tensors
it launches the kernel or raises. Each kernel launch adds one to its entry
in :data:`LAUNCHES` and one to its padded shape ``(nb, ni_p, nr_p)`` in
:data:`LAUNCH_SHAPES`; each factor launch also adds one to its body in
:data:`FACTOR_BODIES` and, for the wide body, to the recording's counter
``kkt.factor_wide`` (``utils.profiling.count``).

Every kernel takes padded interior blocks up to :data:`MAX_INTERIOR` and
reduced blocks up to :data:`MAX_REDUCED`; the wrappers raise
``ValueError`` for wider ones, and the factor for a shape of which not
one lane fits in shared memory, before any launch. The factor and
apply_down kernels have compile-time bodies for the padded interior sizes
in :data:`KERNEL_SIZES`, apply_up for padded reduced blocks of those
sizes; every other size selects the kernel's run-time body
(the same sums, with the per-lane scratch in shared memory). The factor
has two bodies: where a full tile of lanes (one 32-byte sector of each
element) fits in shared memory, one warp per lane and the tile per CTA;
elsewhere (wide blocks) the wide body, one lane per CTA of
:data:`WIDE_WARPS` warps, with compile-time bodies for the padded
interiors 24, 32 and 40 (:func:`factor_tile_lanes`,
:func:`factor_lane_bytes`). :func:`factor_launch` and
:func:`apply_up_launch` read each kernel's body, warps and shared memory
from its launcher. :func:`kernel_cost`
counts the bytes and operations each kernel must move and do, and the
least time an H100 could take for them.

:func:`make_newton_dir` is the port of the reference's batched Newton
rule: the outer delta ladder, refinement against the per-block shifts the
factor kernel used, and residual acceptance, as plain batched torch.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, NamedTuple

import numpy as np
import torch

from pockit_tpu_torch.solver.structured import (
    _tree_sum,
    block_arrow_mv,
    gather_blocks,
    scatter_blocks,
)
from pockit_tpu_torch.utils.profiling import count

_BT = 128  # lane padding of pad_move
MAX_INTERIOR = 64  # widest padded interior block the kernels take
MAX_REDUCED = 128  # widest padded reduced block the kernels take
# padded sizes with compile-time bodies: the interiors of the factor and
# apply_down, apply_up's reduced block
KERNEL_SIZES = (8, 16, 24, 32)
WIDE_WARPS = 8  # warps of a wide-body factor CTA, which factors one lane
SMEM_MAX = 232_448  # shared memory one H100 CTA may opt into (227 KB)

LAUNCHES = {"factor": 0, "apply_down": 0, "apply_up": 0}
LAUNCH_SHAPES = {k: Counter() for k in LAUNCHES}  # {shape: launches} per kernel
FACTOR_BODIES = Counter()  # {"lane_tile" or "wide": factor launches}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_SHAPES[k].clear()
    FACTOR_BODIES.clear()


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _factor_body(ni_p: int, nr_p: int, dtype):
    """(body, lanes per CTA, shared memory of one lane) of the factor at a
    padded shape, as the CUDA launcher (``factor_launch``) picks them. The
    lane tile's lane holds K_ii/L (rows padded to ni_p + 1), sc_i, K_ir/X,
    S/L_r (rows padded to nr_p + 1), sc_r and a 4-element slot
    (``FactorLayout``); its CTA one 32-byte sector of lanes (8 float32 or 4
    float64). Where that tile does not fit in :data:`SMEM_MAX`, the wide
    body runs: one lane per CTA, holding three buffers of K_ii/L and sc_i
    and two of K_ir/t (one of each where those do not fit), S's packed
    lower triangle, sc_r and the slot (``WideLayout``). A shape of which one
    lane-tile lane does not fit is refused (body ``None``, 0 lanes)."""
    item = torch.empty((), dtype=dtype).element_size()
    tile = (ni_p * (ni_p + 1) + ni_p + ni_p * nr_p + nr_p * (nr_p + 1) + nr_p + 4) * item
    full = 32 // item
    fit = SMEM_MAX // tile
    if fit >= full:
        return "lane_tile", full, tile
    if fit < 1:
        return None, 0, tile
    wide = lambda na, nx: (na * (ni_p * (ni_p + 1) + ni_p) + nx * ni_p * nr_p
                           + nr_p * (nr_p + 1) // 2 + nr_p + 4) * item
    return "wide", 1, wide(3, 2) if wide(3, 2) <= SMEM_MAX else wide(1, 1)


def factor_lane_bytes(ni_p: int, nr_p: int, dtype) -> int:
    """Shared memory one lane of the factor holds in the body its shape
    takes (:func:`_factor_body`); for a refused shape, the lane tile's."""
    return _factor_body(ni_p, nr_p, dtype)[2]


def factor_tile_lanes(ni_p: int, nr_p: int, dtype) -> int:
    """Lanes per factor CTA, as the CUDA launcher picks them: one 32-byte
    sector of each element (8 float32 or 4 float64 lanes) in the lane-tile
    body, 1 in the wide body (where that tile would not fit in
    :data:`SMEM_MAX`); 0 where one lane-tile lane does not fit, a shape the
    launcher refuses (a float64 lane at (64, 128) takes 232,480 bytes, 32
    more than a CTA may hold)."""
    return _factor_body(ni_p, nr_p, dtype)[1]


_FACTOR_LAUNCH: dict = {}  # factor_launch's answer per (ni_p, nr_p, dtype)


def factor_launch(ni_p: int, nr_p: int, lanes: int, dtype) -> dict:
    """The factor's launch at a padded shape, read from the kernel library
    (so it needs the CUDA toolkit): the launcher's own choice, which it
    launches. ``body``, ``"lane_tile"`` or ``"wide"``; ``warps`` and
    ``lanes`` per CTA; ``smem``, the CTA's shared memory in bytes. Raises
    ``ValueError`` for a shape the launcher refuses."""
    fl = (ctypes.c_int * 4)()
    rc = _kernel("factor_launch", dtype)(ni_p, nr_p, lanes, fl)
    if rc != 0:
        raise ValueError(f"the factor takes no launch at ni_p={ni_p}, nr_p={nr_p}, "
                         f"lanes={lanes}: cudaError_t {rc}")
    return {"body": ("lane_tile", "wide")[fl[0]], "warps": fl[1], "lanes": fl[2], "smem": fl[3]}


def apply_up_launch(nb: int, ni_p: int, nr_p: int, lanes: int, dtype) -> dict:
    """apply_up's launch at a shape, read from the kernel library (so it
    needs the CUDA toolkit): the launcher's own choice, which it launches.
    ``body``, the built reduced size that runs (0: the run-time body);
    ``warps`` per CTA of 32 lanes, one per interior row up to 8; ``smem``,
    the CTA's shared memory in bytes (a built body holds its lanes' lower
    triangle of L_r, sc_r and r_red; the run-time body x_r alone). Raises
    ``ValueError`` for a shape the launcher refuses."""
    up = (ctypes.c_int * 3)()
    rc = _kernel("apply_up_launch", dtype)(nb, ni_p, nr_p, lanes, up)
    if rc != 0:
        raise ValueError(f"apply_up takes no launch at nb={nb}, ni_p={ni_p}, nr_p={nr_p}, "
                         f"lanes={lanes}: cudaError_t {rc}")
    return dict(zip(("body", "warps", "smem"), up))


def _check_kernel_shape(ni_p: int, nr_p: int):
    """Raise for padded blocks wider than the kernels take."""
    if ni_p > MAX_INTERIOR:
        raise ValueError(f"padded interior blocks wider than {MAX_INTERIOR} are not supported")
    if nr_p > MAX_REDUCED:
        raise ValueError(f"padded reduced blocks wider than {MAX_REDUCED} are not supported")


def kernel_path(interior_pad, reduced, dtype, device) -> str:
    """The KKT path ``kkt_solver="auto"`` takes for a block-arrow layout
    (``BlockKKT.interior_pad (nb, ni)``, ``reduced (nr,)``) in ``dtype`` on
    ``device``, from the padded shape alone, before any launch:
    ``"pallas"`` (the kernels) on a CUDA device where they take the shape
    (interior <= :data:`MAX_INTERIOR`, reduced <= :data:`MAX_REDUCED`
    padded, and one factor lane fits in a CTA's shared memory), else
    ``"block"``, the plain block core. The reference's rule, with the
    kernels' limits in place of its VMEM budget."""
    if torch.device(device).type != "cuda":
        return "block"
    ni_p = _ceil_to(int(np.shape(interior_pad)[-1]), 8)
    nr_p = _ceil_to(len(reduced), 8)
    if ni_p > MAX_INTERIOR or nr_p > MAX_REDUCED or factor_tile_lanes(ni_p, nr_p, dtype) < 1:
        return "block"
    return "pallas"


# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and
# operations/s of each type at its fastest (float32 outside the tensor
# cores, float64 on them)
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}


def _chol_ops(n: int) -> int:
    """Operations one equilibrated Cholesky needs: sc (3 n), and per entry
    on or below the diagonal the scaled entry (3), its dot over the columns
    before it (2 j) and the division by the pivot (on the diagonal, the
    sqrt). About n^3 / 3: the entries above the diagonal are none of its work."""
    return (n - 1) * n * (n + 1) // 3 + 2 * n * (n + 1) + 3 * n


def lane_bytes(name: str, nb: int, ni_p: int, nr_p: int, itemsize: int) -> int:
    """Bytes one lane's call must move: each input its function reads, read
    once, and each output written once. The applies' solves read only the
    lower triangle of L_i and L_r (their plain versions too: nothing above
    the diagonal reaches the result); the factor's plain version reads all
    of K_ii and K_rr (a NaN anywhere reaches its output) and writes all of
    L_i and L_r."""
    tri = lambda n: n * (n + 1) // 2
    elems = {
        # K_ii, K_ir, K_rr, delta; L_i, sc_i, X_ir, L_r, sc_r, piv, d_blk
        "factor": nb * ni_p * ni_p * 2 + nb * ni_p * nr_p * 2 + nr_p * nr_p * 2
        + 1 + nb * ni_p + nr_p + 4 + nb + 1,
        # L_i (lower), sc_i, K_ir, b_i, b_r; x_bi, r_red
        "apply_down": nb * tri(ni_p) + nb * ni_p + nb * ni_p * nr_p + nb * ni_p + nr_p
        + nb * ni_p + nr_p,
        # L_r (lower), sc_r, r_red, X_ir, x_bi; x_r, x_i
        "apply_up": tri(nr_p) + 2 * nr_p + nb * ni_p * nr_p + nb * ni_p + nr_p + nb * ni_p,
    }[name]
    return elems * itemsize


def lane_ops(name: str, nb: int, ni_p: int, nr_p: int) -> int:
    """Arithmetic operations (each add, multiply, divide and sqrt one) that
    one lane's call needs, with one Cholesky attempt per block. The factor's
    Schur update counts the lower half of S, all the reduced Cholesky reads."""
    if name == "factor":
        sub = nr_p * (ni_p**2 + ni_p)  # one triangular solve of the nr_p columns
        per_block = _chol_ops(ni_p) + 2 * sub + ni_p * nr_p * (nr_p + 1)
        return nb * per_block + 2 * nr_p**2 + _chol_ops(nr_p)
    if name == "apply_down":
        return nb * (2 * ni_p**2 + 2 * ni_p + 2 * ni_p * nr_p + nr_p)
    return 2 * nr_p**2 + 2 * nr_p + nb * ni_p * (2 * nr_p + 1)


def kernel_cost(name, nb, ni_p, nr_p, lanes, dtype, chol_retries=0) -> dict:
    """Bytes and operations of one call on ``lanes`` lanes, and its bound:
    the larger of bytes over the H100's memory rate and operations over its
    peak for ``dtype``. ``chol_retries`` adds the extra Cholesky attempts
    of the retry ladder (interior blocks) that this call's data needs."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = lanes * lane_bytes(name, nb, ni_p, nr_p, item)
    ops = lanes * lane_ops(name, nb, ni_p, nr_p) + chol_retries * _chol_ops(ni_p)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S[dtype] * 1e3
    return {
        "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


# ---------------------------------------------------------------------------
# plain versions (lanes trailing; the Pallas bodies in batched torch)
# ---------------------------------------------------------------------------


def _fwd_sub(L, B):
    """Solve L t = B for lower-triangular L (n, n, BT), B (n, m, BT); dot
    form with tree-summed inner products."""
    n = L.shape[0]
    ts = []
    for k in range(n):
        v = B[k]
        if k:
            v = v - _tree_sum([ts[j] * L[k, j, :][None, :] for j in range(k)])
        ts.append(v / L[k, k, :][None, :])
    return torch.stack(ts, dim=0)


def _bwd_sub(L, B):
    """Solve L^T x = B for lower-triangular L (n, n, BT), B (n, m, BT)."""
    n = L.shape[0]
    xs = [None] * n
    for k in reversed(range(n)):
        v = B[k]
        if k < n - 1:
            v = v - _tree_sum([xs[j] * L[j, k, :][None, :] for j in range(k + 1, n)])
        xs[k] = v / L[k, k, :][None, :]
    return torch.stack(xs, dim=0)


def _blk_solve_lanes(L, sc, B):
    """(L L^T)-solve with the equilibration folded in: sc * solve(sc * B)."""
    t = _fwd_sub(L, B * sc[:, None, :])
    return _bwd_sub(L, t) * sc[:, None, :]


def _chol_lanes(A, nn, n_real, d):
    """Left-looking Cholesky of ``A + d*I`` (A (nn, nn, BT)) with Jacobi
    equilibration. Negative pivots surface as NaN through ``sqrt`` and
    ``torch.minimum``/``maximum`` carry them into the extrema; padded rows
    (>= n_real) are excluded from the extrema. Returns (L, sc, dmin, dmax)."""
    dtype, dev = A.dtype, A.device
    diag = torch.diagonal(A, dim1=0, dim2=1).T + d[None, :]
    sc = torch.rsqrt(torch.maximum(diag, torch.tensor(1e-30, dtype=dtype, device=dev)))
    BT = A.shape[-1]
    dmin = torch.full((BT,), torch.inf, dtype=dtype, device=dev)
    dmax = torch.full((BT,), -torch.inf, dtype=dtype, device=dev)
    rows = torch.arange(nn, device=dev)[:, None]
    cols = []
    for k in range(nn):
        onk = (rows == k).to(dtype)
        v = (A[:, k, :] + onk * d[None, :]) * sc * sc[k][None, :]
        if k:
            v = v - _tree_sum([cols[j] * cols[j][k][None, :] for j in range(k)])
        dk = torch.sqrt(v[k, :])
        if k < n_real:
            dmin = torch.minimum(dmin, dk)
            dmax = torch.maximum(dmax, dk)
        inv = 1.0 / dk
        mask = (rows > k).to(dtype)
        cols.append(v * inv[None, :] * mask + onk * dk[None, :])
    return torch.stack(cols, dim=1), sc, dmin, dmax


def _passes(dmin, dmax, pivot_rtol):
    return torch.isfinite(dmin) & torch.isfinite(dmax) & (dmin > pivot_rtol * dmax)


def _attempted_chol(A, nn, n_real, base_d, pivot_rtol, delta_floor, attempts):
    """Factor ``A + d*I`` with the block-local retry ladder: a failing lane
    bumps its d (to ``delta_floor``, then x10) and refactors, up to
    ``attempts - 1`` times. Lanes whose d is unchanged recompute identical
    values, so the whole batch refactors."""
    L, sc, dmin, dmax = _chol_lanes(A, nn, n_real, base_d)
    d = base_d
    for _ in range(attempts - 1):
        need = ~_passes(dmin, dmax, pivot_rtol)
        if bool(need.any()):
            d = torch.where(need, torch.where(d < delta_floor, delta_floor, d * 10.0), d)
            L, sc, dmin, dmax = _chol_lanes(A, nn, n_real, d)
    return L, sc, dmin, dmax, d


def factor_blocks_ref(
    K_ii, K_ir, K_rr, delta, *, ni_real, nr_real, pivot_rtol, delta_floor, attempts
):
    """Plain version of :func:`factor_blocks`."""
    nb, ni_p, _, BT = K_ii.shape
    nr_p = K_rr.shape[0]
    dtype, dev = K_ii.dtype, K_ii.device
    piv_min = torch.full((BT,), torch.inf, dtype=dtype, device=dev)
    piv_max = torch.full((BT,), -torch.inf, dtype=dtype, device=dev)
    d_up = delta
    ok_all = torch.ones((BT,), dtype=dtype, device=dev)
    eye_r = torch.eye(nr_p, dtype=dtype, device=dev)[:, :, None]
    S = K_rr + eye_r * delta[None, None, :]
    L_i, sc_i, X_ir, d_blk = [], [], [], []
    for b in range(nb):
        L, sc, dmin, dmax, d_b = _attempted_chol(
            K_ii[b], ni_p, ni_real, delta, pivot_rtol, delta_floor, attempts
        )
        # block-local acceptance: each block judged at its own final delta
        ok_all = ok_all * _passes(dmin, dmax, pivot_rtol).to(dtype)
        d_blk.append(d_b)
        t = _fwd_sub(L, K_ir[b] * sc[:, None, :])  # L^{-1} sc K_ir
        X_ir.append(_bwd_sub(L, t) * sc[:, None, :])  # K_ii^{-1} K_ir
        L_i.append(L)
        sc_i.append(sc)
        # Schur accumulation in Gram form, S -= t^T t, tree-summed over i
        S = S - _tree_sum([t[i][None, :, :] * t[i][:, None, :] for i in range(ni_p)])
        piv_min = torch.minimum(piv_min, dmin)
        piv_max = torch.maximum(piv_max, dmax)
        d_up = torch.maximum(d_up, d_b)
    # reduced block: the base delta is already in S; retries add extra
    L_r, sc_r, dmin, dmax, d_r = _attempted_chol(
        S, nr_p, nr_real, torch.zeros_like(delta), pivot_rtol, delta_floor, attempts
    )
    ok_r = _passes(dmin, dmax, pivot_rtol)
    d_blk.append(delta + d_r)
    pmin = torch.minimum(piv_min, dmin)
    pmax = torch.maximum(piv_max, dmax)
    finite = torch.isfinite(pmin) & torch.isfinite(pmax)
    piv = torch.stack(
        [
            torch.where(finite, pmin, torch.nan),
            torch.where(finite, pmax, torch.nan),
            torch.maximum(d_up, delta + d_r),
            ok_all * ok_r.to(dtype),
        ]
    )
    return (
        torch.stack(L_i),
        torch.stack(sc_i),
        torch.stack(X_ir),
        L_r,
        sc_r,
        piv,
        torch.stack(d_blk),
    )


def apply_down_ref(L_i, sc_i, K_ir, b_i, b_r):
    """Plain version of :func:`apply_down`."""
    r_red = b_r
    x_bi = []
    for b in range(L_i.shape[0]):
        x = _blk_solve_lanes(L_i[b], sc_i[b], b_i[b][:, None, :])[:, 0, :]
        x_bi.append(x)
        r_red = r_red - (K_ir[b] * x[:, None, :]).sum(0)
    return torch.stack(x_bi), r_red


def apply_up_ref(L_r, sc_r, r_red, X_ir, x_bi):
    """Plain version of :func:`apply_up`."""
    x_r = _blk_solve_lanes(L_r, sc_r, r_red[:, None, :])[:, 0, :]
    x_i = x_bi - (X_ir * x_r[None, None, :, :]).sum(2)
    return x_r, x_i


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*ts) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {kinds}")


def _check(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _kernel(name, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA kernels take float32 or float64, got {dtype}")
    from pockit_tpu_torch.solver._build import load

    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(load(), f"bak_{name}_{suffix}")


def _launch(name, shape, fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name][shape] += 1


def factor_blocks(
    K_ii, K_ir, K_rr, delta, *, ni_real, nr_real, pivot_rtol, delta_floor, attempts
):
    """Factor the padded batch-last block-arrow matrix ``K + delta*I``.

    ``K_ii (nb, ni_p, ni_p, BT)``, ``K_ir (nb, ni_p, nr_p, BT)``, ``K_rr
    (nr_p, nr_p, BT)``, ``delta (BT,)``. Returns ``(L_i, sc_i, X_ir, L_r,
    sc_r, piv, d_blk)``: ``piv (4, BT)`` = (pivot min, pivot max, largest
    delta used, lane accepted), ``d_blk (nb+1, BT)`` the per-block delta
    levels actually factored."""
    kw = dict(
        ni_real=ni_real, nr_real=nr_real, pivot_rtol=pivot_rtol,
        delta_floor=delta_floor, attempts=attempts,
    )
    if _on_cpu(K_ii, K_ir, K_rr, delta):
        return factor_blocks_ref(K_ii, K_ir, K_rr, delta, **kw)
    nb, ni_p, _, BT = K_ii.shape
    nr_p = K_rr.shape[0]
    dt = K_ii.dtype
    _check_kernel_shape(ni_p, nr_p)
    if factor_tile_lanes(ni_p, nr_p, dt) < 1:
        raise ValueError(f"one factor lane at ni_p={ni_p}, nr_p={nr_p} in {dt} takes "
                         f"{factor_lane_bytes(ni_p, nr_p, dt)} bytes of shared memory, "
                         f"more than the {SMEM_MAX} a CTA may hold")
    _check("K_ii", K_ii, (nb, ni_p, ni_p, BT), dt)
    _check("K_ir", K_ir, (nb, ni_p, nr_p, BT), dt)
    _check("K_rr", K_rr, (nr_p, nr_p, BT), dt)
    _check("delta", delta, (BT,), dt)
    e = lambda *s: torch.empty(s + (BT,), dtype=dt, device=K_ii.device)
    out = (e(nb, ni_p, ni_p), e(nb, ni_p), e(nb, ni_p, nr_p), e(nr_p, nr_p),
           e(nr_p), e(4), e(nb + 1))
    s_scr = e(nr_p, nr_p)
    _launch(
        "factor", (nb, ni_p, nr_p), _kernel("factor", dt), K_ii, K_ir, K_rr, delta, *out, s_scr,
        nb, ni_p, nr_p, int(ni_real), int(nr_real), BT,
        float(pivot_rtol), float(delta_floor), int(attempts),
    )
    key = (ni_p, nr_p, dt)
    if key not in _FACTOR_LAUNCH:
        _FACTOR_LAUNCH[key] = factor_launch(ni_p, nr_p, BT, dt)["body"]
    FACTOR_BODIES[_FACTOR_LAUNCH[key]] += 1
    if _FACTOR_LAUNCH[key] == "wide":
        count("kkt.factor_wide")
    return out


def apply_down(L_i, sc_i, K_ir, b_i, b_r):
    """Interior solves ``x_bi = sc (L L^T)^{-1} sc b_i`` per block and the
    reduced right-hand side ``r_red = b_r - Σ_b K_ir^T x_bi`` (block
    order). Returns ``(x_bi (nb, ni_p, BT), r_red (nr_p, BT))``."""
    if _on_cpu(L_i, sc_i, K_ir, b_i, b_r):
        return apply_down_ref(L_i, sc_i, K_ir, b_i, b_r)
    nb, ni_p, nr_p, BT = K_ir.shape
    _check_kernel_shape(ni_p, nr_p)
    dt = L_i.dtype
    _check("L_i", L_i, (nb, ni_p, ni_p, BT), dt)
    _check("sc_i", sc_i, (nb, ni_p, BT), dt)
    _check("K_ir", K_ir, (nb, ni_p, nr_p, BT), dt)
    _check("b_i", b_i, (nb, ni_p, BT), dt)
    _check("b_r", b_r, (nr_p, BT), dt)
    x_bi = torch.empty_like(b_i)
    r_red = torch.empty_like(b_r)
    _launch(
        "apply_down", (nb, ni_p, nr_p), _kernel("apply_down", dt), L_i, sc_i, K_ir, b_i, b_r,
        x_bi, r_red, nb, ni_p, nr_p, BT,
    )
    return x_bi, r_red


def apply_up(L_r, sc_r, r_red, X_ir, x_bi):
    """Reduced solve ``x_r = sc_r (L_r L_r^T)^{-1} sc_r r_red`` and the
    interiors ``x_i = x_bi - X_ir x_r``. Returns ``(x_r (nr_p, BT), x_i
    (nb, ni_p, BT))``."""
    if _on_cpu(L_r, sc_r, r_red, X_ir, x_bi):
        return apply_up_ref(L_r, sc_r, r_red, X_ir, x_bi)
    nb, ni_p, nr_p, BT = X_ir.shape
    _check_kernel_shape(ni_p, nr_p)
    dt = L_r.dtype
    _check("L_r", L_r, (nr_p, nr_p, BT), dt)
    _check("sc_r", sc_r, (nr_p, BT), dt)
    _check("r_red", r_red, (nr_p, BT), dt)
    _check("X_ir", X_ir, (nb, ni_p, nr_p, BT), dt)
    _check("x_bi", x_bi, (nb, ni_p, BT), dt)
    x_r = torch.empty_like(r_red)
    x_i = torch.empty_like(x_bi)
    _launch(
        "apply_up", (nb, ni_p, nr_p), _kernel("apply_up", dt), L_r, sc_r, r_red, X_ir, x_bi,
        x_r, x_i, nb, ni_p, nr_p, BT,
    )
    return x_r, x_i


# ---------------------------------------------------------------------------
# batch-leading core used by the solver
# ---------------------------------------------------------------------------


class KKTCore(NamedTuple):
    """Factor/apply over the padded batch-last layout."""

    factor: Callable  # batch-last padded blocks, delta -> fac, pmin, pmax, d_used, d_blk, ok
    apply: Callable  # (fac, rhs (B, n)) -> x (B, n)
    pad_move: Callable  # batch-leading blocks -> batch-last padded
    ni_p: int
    nr_p: int


def make_core(interior, reduced, n, pivot_rtol=None, delta_w_floor=None, attempts=1):
    """The port of the reference's ``_make_pallas_core``."""
    interior = np.asarray(interior)
    reduced = np.asarray(reduced)
    nb, ni = interior.shape
    nr = len(reduced)
    ni_p, nr_p = _ceil_to(ni, 8), _ceil_to(nr, 8)
    eps32 = float(np.finfo(np.float32).eps)
    if pivot_rtol is None:
        pivot_rtol = 2.0 * float(np.sqrt(eps32))
    if delta_w_floor is None:
        delta_w_floor = 10.0 * eps32
    interior_t = torch.as_tensor(interior.astype(np.int64))
    reduced_t = torch.as_tensor(reduced.astype(np.int64))

    def pad_move(K_ii, K_ir, K_rr):
        """(B, ...) blocks -> batch-last, rows/cols padded to 8-multiples
        with unit diagonal (padded pivots are exactly 1), lanes padded to
        a 128-multiple (padded lanes are garbage, sliced away)."""
        dtype, dev = K_ii.dtype, K_ii.device
        B = K_ii.shape[0]
        B_pad = _ceil_to(B, _BT)
        F = torch.nn.functional
        lane = lambda a: F.pad(a.movedim(0, -1), (0, B_pad - B))
        K_ii = lane(F.pad(K_ii, (0, ni_p - ni, 0, ni_p - ni)))
        K_ir = lane(F.pad(K_ir, (0, nr_p - nr, 0, ni_p - ni)))
        K_rr = lane(F.pad(K_rr, (0, nr_p - nr, 0, nr_p - nr)))
        # unit pivots on the padded rows of every lane, padded lanes too
        pad_eye = lambda n, n_real: torch.diag(
            (torch.arange(n, device=dev) >= n_real).to(dtype)
        )[:, :, None]
        K_ii = K_ii + pad_eye(ni_p, ni)
        K_rr = K_rr + pad_eye(nr_p, nr)
        return K_ii.contiguous(), K_ir.contiguous(), K_rr.contiguous()

    def factor(K_ii, K_ir, K_rr, delta):
        """Batch-last padded inputs and per-lane base ``delta (B,)``.
        Returns (fac, p_min, p_max, delta_used, d_blk (nb+1, B), ok)."""
        L_i, sc_i, X_ir, L_r, sc_r, piv, d_blk = factor_blocks(
            K_ii, K_ir, K_rr, delta.to(K_ii.dtype).contiguous(),
            ni_real=ni, nr_real=nr, pivot_rtol=float(pivot_rtol),
            delta_floor=float(delta_w_floor), attempts=int(attempts),
        )
        fac = (L_i, sc_i, X_ir, K_ir, L_r, sc_r)
        return fac, piv[0], piv[1], piv[2], d_blk, piv[3] > 0.5

    def apply(fac, rhs):
        """fac batch-last padded (B_pad lanes); rhs (B, n) -> x (B, n)."""
        L_i, sc_i, X_ir, K_ir, L_r, sc_r = fac
        B_out = rhs.shape[0]
        B = L_i.shape[-1]
        F = torch.nn.functional
        idx_i, idx_r = interior_t.to(rhs.device), reduced_t.to(rhs.device)
        b_i, b_r = gather_blocks(F.pad(rhs, (0, 0, 0, B - B_out)), idx_i, idx_r)
        b_i = F.pad(b_i, (0, ni_p - ni)).permute(1, 2, 0).contiguous()
        b_r = F.pad(b_r, (0, nr_p - nr)).T.contiguous()
        x_bi, r_red = apply_down(L_i, sc_i, K_ir, b_i, b_r)
        x_r, x_i = apply_up(L_r, sc_r, r_red, X_ir, x_bi)
        x = scatter_blocks(
            x_i[:, :ni, :B_out].permute(2, 0, 1), x_r[:nr, :B_out].T, idx_i, idx_r, n
        )
        return x

    return KKTCore(factor=factor, apply=apply, pad_move=pad_move, ni_p=ni_p, nr_p=nr_p)


def make_newton_dir(
    interior,
    reduced,
    n: int,
    *,
    pivot_rtol: float,
    max_reg_tries: int,
    delta_w_floor: float,
    delta_w_max: float,
    refine_steps: int = 1,
    attempts: int = 1,
    residual_rtol: float = 1e-2,
):
    """Build ``(newton_dir, apply)`` for the CUDA KKT path (the port of the
    reference's batched ``_newton_rule``).

    - ``newton_dir(K_ii, K_ir, K_rr, rhs, dreg, step_cap, active) -> (dz,
      fac, delta_w, ok)`` on batch-leading blocks: factor at the per-lane
      ``dreg``, then escalate (floor, then x10 up to ``delta_w_max``) while
      an ACTIVE lane fails, re-solving the whole batch each round.
    - ``apply(fac, b (B, n)) -> x`` back-solves any rhs with the factors.
    """
    interior = np.asarray(interior)
    reduced = np.asarray(reduced)
    core = make_core(
        interior, reduced, n, pivot_rtol=pivot_rtol,
        delta_w_floor=delta_w_floor, attempts=attempts,
    )
    interior_t = torch.as_tensor(interior.astype(np.int64))
    reduced_t = torch.as_tensor(reduced.astype(np.int64))

    def _ba_mv(K_ii, K_ir, K_rr, d_int, d_red, x):
        """Block-arrow matvec with PER-BLOCK diagonal shifts: the levels the
        factor kernel actually used, so refinement targets the factored
        operator."""
        idx_i, idx_r = interior_t.to(x.device), reduced_t.to(x.device)
        return block_arrow_mv(K_ii, K_ir, K_rr, d_int, d_red, x, idx_i, idx_r)

    def _schedule(delta, tries, dreg):
        """Escalation rung ``tries`` >= 1 of the solver's reg ladder: the
        floor first (when the entry level is below it), then x10."""
        up = torch.clamp(torch.clamp_min(delta, delta_w_floor) * 10.0, max=delta_w_max)
        if tries == 1:
            return torch.where(dreg < delta_w_floor, delta_w_floor, up)
        return up

    def newton_dir(K_ii, K_ir, K_rr, rhs, dreg, step_cap, active):
        B = rhs.shape[0]
        Kii_t, Kir_t, Krr_t = core.pad_move(K_ii, K_ir, K_rr)
        B_pad = Kii_t.shape[-1]
        norm = lambda a: torch.linalg.vector_norm(a, dim=1)

        def try_delta(delta):
            count("ipm.factor_tries")
            delta_p = torch.nn.functional.pad(delta, (0, B_pad - B))
            fac, _, _, d_used, d_blk, allok = core.factor(Kii_t, Kir_t, Krr_t, delta_p)
            d_used = d_used[:B]
            chol_ok = allok[:B]
            d_blk = d_blk.T[:B]  # (B, nb+1)
            dz = core.apply(fac, rhs)
            for _ in range(refine_steps):
                r = rhs - _ba_mv(K_ii, K_ir, K_rr, d_blk[:, :-1], d_blk[:, -1], dz)
                dz_t = dz + core.apply(fac, r)
                dz = torch.where(torch.isfinite(dz_t).all(1, keepdim=True), dz_t, dz)
            ok = chol_ok & torch.isfinite(dz).all(1) & (norm(dz) <= step_cap)
            if residual_rtol:
                # a "passed" factorization of a singular block gives a solve
                # that does not solve: reject it per lane and escalate
                r_fin = rhs - _ba_mv(K_ii, K_ir, K_rr, d_blk[:, :-1], d_blk[:, -1], dz)
                ok = ok & (norm(r_fin) <= residual_rtol * torch.clamp_min(norm(rhs), 1e-30))
            dz = torch.where(ok[:, None], dz, 0.0)
            return fac, dz, ok, d_used

        delta0 = dreg.to(rhs.dtype).expand(B)
        fac, dz, ok, delta = try_delta(delta0)
        tries = 1
        # a failing INACTIVE lane (its step is discarded this iteration)
        # never buys the whole batch another factorization round
        while tries < max_reg_tries and bool(((~ok) & active).any()):
            delta_new = torch.where(ok | ~active, delta, _schedule(delta, tries, dreg))
            fac, dz, ok_new, d_used = try_delta(delta_new)
            delta = torch.where(ok, delta, d_used)
            ok = ok | ok_new
            tries += 1
        return dz, fac, delta, ok

    return newton_dir, core.apply
