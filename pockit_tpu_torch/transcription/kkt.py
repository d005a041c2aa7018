"""Block-arrow KKT assembly from pointwise AD (``torch.func``).

The port of ``make_block_kkt`` in ``pockit_tpu/transcription/kkt.py``. The
condensed interior-point matrix

    K = W + diag(sigma_z) + delta_w I + J^T D J

is assembled directly in block-arrow storage ``K_ii (nb, ni, ni)``,
``K_ir (nb, ni, nr)``, ``K_rr (nr, nr)``. Every nonlinear function of the
transcription is evaluated per collocation point on ``n_pt = n_x + n_u +
2 + n_s`` arguments, so the interval Hessian is a static placement of
pointwise ``(n_pt, n_pt)`` Hessians (``vmap(jacfwd(grad(phi)))``) and the
interval Jacobian the translation block plus an integration-operator
contraction of pointwise Jacobians. FIXED / FUNC boundary substitutions
become an explicit chain-rule column transform; shared LGL border rows are
half-weighted in each adjacent block.

The Lagrangian head ``Phi = fct_o F_o(I, s) + y_sys . c_sys(I, s)`` is
split exactly as in the reference: ``dPhi/dI`` at the current point weights
each integrand's pointwise Hessian and ``d2Phi/ds2`` lands in ``K_rr``; the
remainder is the low-rank term counted by ``layout.krylov_rank``.

``assemble(z, y, D, rt)`` works on ONE lane; the solver batches it with
``torch.func.vmap``. The one-hot placement contractions of the reference
are kept as einsums: they read as the index maps they are.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

from pockit_tpu_torch.base.bc import BcType
from pockit_tpu_torch.solver.structured import StructuredLayout, structured_layout
from pockit_tpu_torch.transcription.compiled import _ConstCache
from pockit_tpu_torch.utils.profiling import count


class BlockKKT(NamedTuple):
    """Static layout + assembly closures for the block-arrow KKT path.

    - ``layout``: the :class:`StructuredLayout`.
    - ``interior_pad``: (nb, ni_max) interior columns (``layout.interior``).
    - ``assemble(z, y, D, rt, fct_o=1.0)``: per lane, ``(K_ii, K_ir,
      K_rr)`` of ``W + J^T diag(D) J`` restricted to the block-arrow
      pattern; ``sigma_z`` and ``delta_w`` diagonals are the solver's.
    - ``integrals(z, rt)``: per lane, every phase integral.
    """

    layout: StructuredLayout
    interior_pad: np.ndarray
    ni_max: int
    n_blocks: int
    assemble: Callable
    integrals: Callable = None


def _phase_interval_data(system, pi: int, row0: int, ivals=None):
    """Host-side static data for a uniform-degree GROUP of one phase's
    intervals (``ivals``; all intervals when ``None``).

    hp-refined meshes carry per-interval degrees; callers bucket the
    intervals by degree and build one group per bucket so every array
    here stays rectangular (no point padding — padded collocation points
    would evaluate user dynamics at arbitrary argument values, where
    e.g. ``1/m`` terms produce non-finite garbage even at zero weight).

    Returns a dict with per-interval local column indices, constraint-row
    indices + weights, interval operators, and BC substitution tables.
    """
    p = system.p[pi]
    d = p.d
    off = int(system.l_p[pi])
    if ivals is None:
        ivals = list(range(d.N))
    degs = {int(d.num_point[i]) for i in ivals}
    assert len(degs) == 1, f"mixed degrees in one group: {degs}"
    n = degs.pop()
    N = len(ivals)
    lob = d.family == "lobatto"
    n_x, n_u, n_s = p.n_x, p.n_u, system.n_s
    pts_x = n if lob else n + 1
    pts_u = n
    dyn_rows = (n - 1 if lob else n)  # per state per interval
    n_loc = n_x * pts_x + n_u * pts_u + 2 + n_s

    # ---- local columns: per state, per control, t_0, t_f, statics ----
    if lob:
        lx, rx = d.l_m, d.r_m
        lu, ru = d.l_m, d.r_m
    else:
        lx, rx = d.l_x, d.r_x
        lu, ru = d.l_u, d.r_u
    local_cols = np.empty((N, n_loc), dtype=np.int64)
    for bi, i in enumerate(ivals):
        c = []
        for v in range(n_x):
            base = off + int(d.l_v[v])
            c.extend(range(base + int(lx[i]), base + int(rx[i])))
        for v in range(n_u):
            base = off + int(d.l_v[n_x + v])
            c.extend(range(base + int(lu[i]), base + int(ru[i])))
        c.extend([off + p.L - 2, off + p.L - 1])
        c.extend(range(int(system.l_s), int(system.r_s)))
        local_cols[bi] = c

    # ---- constraint rows of each interval + sharing weights ----------
    # global constraint ordering: [system rows | per phase: dynamic rows
    # (state-major over L_d) then path rows (constraint-major over L_m)]
    from pockit_tpu_torch.numerics.layout import lr_nc

    l_dr, _ = lr_nc(d.num_point - 1 if lob else d.num_point)
    L_d, L_m = int(d.L_d), int(d.L_m)
    rows_i = n_x * dyn_rows + p.n_c * pts_u
    row_idx = np.empty((N, rows_i), dtype=np.int64)
    row_w = np.ones((N, rows_i))
    for bi, i in enumerate(ivals):
        rr = []
        for v in range(n_x):
            r0 = row0 + v * L_d + int(l_dr[i])
            rr.extend(range(r0, r0 + dyn_rows))
        pb = row0 + n_x * L_d
        pts = int(d.r_m[i]) - int(d.l_m[i])
        assert pts == pts_u, (pts, pts_u)
        for c in range(p.n_c):
            r0 = pb + c * L_m + int(d.l_m[i])
            rr.extend(range(r0, r0 + pts))
            if lob:
                # shared-border path rows appear in both adjacent blocks:
                # half-weight each copy so their sum counts the row once
                # (position in the PHASE, not the group, decides sharing)
                k = n_x * dyn_rows + c * pts
                if i > 0:
                    row_w[bi, k] = 0.5
                if i < d.N - 1:
                    row_w[bi, k + pts - 1] = 0.5
        row_idx[bi] = rr

    # ---- per-interval operators --------------------------------------
    from pockit_tpu_torch.base.discretization import (
        _integration_block,
        _translation_block,
    )

    width = np.diff(d.mesh)[ivals]
    T_blk = np.broadcast_to(
        _translation_block(d.family, n), (N, dyn_rows, pts_x)
    ).copy()
    I_unit = _integration_block(d.family, n)
    I_blk = I_unit[None, :, :] * (width[:, None, None] / 2)
    # reference-cell nodes/weights of the interval, scaled into its cell
    tau = np.empty((N, pts_u))
    w_blk = np.empty((N, pts_u))
    for bi, i in enumerate(ivals):
        tau[bi] = d.t_m[int(d.l_m[i]) : int(d.r_m[i])]
        # w_m accumulates shared-border weights (LGL): rebuild per-interval
        w_blk[bi] = np.asarray(d.w_itv[i]) * width[bi] / 2

    # ---- boundary-condition substitution tables ----------------------
    # runtime FIXED values arrive via rt["bc"][pi], ordered like
    # compiled.py's fixed_idx (states bc_0, states bc_f, t_0, t_f)
    slots = (
        [(int(d.l_v[v]) + 0, p.info_bc_0[v]) for v in range(n_x)]
        + [(int(d.r_v[v]) - 1, p.info_bc_f[v]) for v in range(n_x)]
        + [(p.L - 2, p.info_t_0), (p.L - 1, p.info_t_f)]
    )
    fixed_mask = np.zeros((N, n_loc), dtype=bool)
    fixed_slot = np.zeros((N, n_loc), dtype=np.int64)
    func_mask = np.zeros((N, n_loc), dtype=bool)
    func_slot = np.zeros((N, n_loc), dtype=np.int64)
    func_fns = []
    n_fixed = 0
    bc_owned = set()
    for idx, info in slots:
        g_idx = off + idx
        if info.t == BcType.FIXED:
            sel = local_cols == g_idx
            fixed_mask |= sel
            fixed_slot[sel] = n_fixed
            n_fixed += 1
            bc_owned.add(idx)
        elif info.t == BcType.FUNC:
            sel = local_cols == g_idx
            func_mask |= sel
            func_slot[sel] = len(func_fns)
            func_fns.append(info.v)
            bc_owned.add(idx)
    # pinned (lb == ub) variable slots: appended after the BC slots in the
    # SAME order as compiled.py's fixed_idx so the runtime bc vector lines
    # up; BC-owned slots skipped identically
    for idx, _val in p.pinned_variable_slots:
        if idx in bc_owned:
            continue
        sel = local_cols == off + idx
        fixed_mask |= sel
        fixed_slot[sel] = n_fixed
        n_fixed += 1

    return dict(
        phase=p,
        pi=pi,
        ivals=np.asarray(ivals, dtype=np.int64),
        lob=lob,
        n=n,
        N=N,
        n_x=n_x,
        n_u=n_u,
        n_s=n_s,
        pts_x=pts_x,
        pts_u=pts_u,
        dyn_rows=dyn_rows,
        n_loc=n_loc,
        local_cols=local_cols,
        row_idx=row_idx,
        row_w=row_w,
        T_blk=T_blk,
        I_blk=I_blk,
        tau=tau,
        w_blk=w_blk,
        fixed_mask=fixed_mask,
        fixed_slot=fixed_slot,
        func_mask=func_mask,
        func_slot=func_slot,
        func_fns=func_fns,
        n_fixed=n_fixed,
    )




def _make_subst(n_loc, n_s, func_fns, n_fixed):
    """Runtime substitution of FIXED (from the bc vector) and FUNC (from
    the statics) boundary entries into the local vector."""

    def subst(z_loc, fm, fsl, qm, qsl, bc):
        if n_fixed:
            z_loc = torch.where(fm, bc[fsl], z_loc)
        if func_fns:
            s_loc = z_loc[n_loc - n_s :]
            vals = torch.stack([fn(list(s_loc)) for fn in func_fns])
            z_loc = torch.where(qm, vals[qsl], z_loc)
        return z_loc

    return subst


def _make_interval_integrals(ph):
    """Per-interval contribution to the phase integrals, ``(n_I,)``."""
    p = ph["phase"]
    n_x, n_u, n_s = ph["n_x"], ph["n_u"], ph["n_s"]
    pts_x, pts_u, n_loc = ph["pts_x"], ph["pts_u"], ph["n_loc"]
    lob = ph["lob"]
    i_t0 = n_loc - n_s - 2
    i_tf = n_loc - n_s - 1
    subst = _make_subst(n_loc, n_s, ph["func_fns"], ph["n_fixed"])

    def ivals(z_loc, tau_i, w_i, fm, fsl, qm, qsl, bc):
        z_sub = subst(z_loc, fm, fsl, qm, qsl, bc)
        t0, tf = z_sub[i_t0], z_sub[i_tf]
        xs = [z_sub[v * pts_x : (v + 1) * pts_x] for v in range(n_x)]
        u0 = n_x * pts_x
        us = [z_sub[u0 + w * pts_u : u0 + (w + 1) * pts_u] for w in range(n_u)]
        s = [z_sub[n_loc - n_s + k] for k in range(n_s)]
        t_mid = (tau_i - 0.5) * (tf - t0) + (tf + t0) / 2
        xm = xs if lob else [x[:-1] for x in xs]
        args = xm + us + [t_mid] + s
        return torch.stack([fI(args) @ w_i for fI in p.F_I]) * (tf - t0)

    return ivals


def _make_pointwise_m(ph):
    """Per-interval M = W + J^T diag(D) J from pointwise AD:
    ``interval_M(z_loc, Ib, tau_i, w_i, fm, fsl, qm, qsl, bc, lam_i, D_i,
    alpha) -> (n_loc, n_loc)``."""
    p = ph["phase"]
    n_x, n_u, n_s = ph["n_x"], ph["n_u"], ph["n_s"]
    pts_x, pts_u, n_loc = ph["pts_x"], ph["pts_u"], ph["n_loc"]
    dyn_rows = ph["dyn_rows"]
    n_c, n_I = p.n_c, p.n_I
    func_fns = ph["func_fns"]
    i_t0 = n_loc - n_s - 2
    i_tf = n_loc - n_s - 1
    s0c = n_loc - n_s
    n_pt = n_x + n_u + 2 + n_s

    subst = _make_subst(n_loc, n_s, func_fns, ph["n_fixed"])

    # static point-arg -> local-column map as a one-hot placement tensor
    cm = np.empty((pts_u, n_pt), dtype=np.int64)
    for q in range(pts_u):
        c = [v * pts_x + q for v in range(n_x)]
        c += [n_x * pts_x + w * pts_u + q for w in range(n_u)]
        c += [i_t0, i_tf]
        c += [s0c + k for k in range(n_s)]
        cm[q] = c
    S_cm = np.zeros((pts_u, n_pt, n_loc), dtype=np.float64)
    S_cm[np.arange(pts_u)[:, None], np.arange(n_pt)[None, :], cm] = 1.0

    # static linear Jacobian rows: d(X @ Tb.T)/d z_sub
    Tb = np.asarray(ph["T_blk"][0])
    A_lin = np.zeros((n_x * dyn_rows, n_loc))
    for v in range(n_x):
        A_lin[v * dyn_rows : (v + 1) * dyn_rows, v * pts_x : (v + 1) * pts_x] = Tb
    consts = _ConstCache(S_cm=S_cm, A_lin=A_lin)

    fnvs = [
        (lambda fn: lambda sv: fn([sv[k] for k in range(n_s)]).reshape(()))(fn)
        for fn in func_fns
    ]

    def _point_args(pv, tq):
        xs = [pv[v] for v in range(n_x)]
        us = [pv[n_x + w] for w in range(n_u)]
        t0q, tfq = pv[n_x + n_u], pv[n_x + n_u + 1]
        sq = [pv[n_x + n_u + 2 + k] for k in range(n_s)]
        t_mid = (tq - 0.5) * (tfq - t0q) + (tfq + t0q) / 2
        return xs + us + [t_mid] + sq, t0q, tfq

    def phi(pv, kq, lpq, wq, tq, alpha):
        args, t0q, tfq = _point_args(pv, tq)
        dt = tfq - t0q
        val = pv.new_zeros(())
        if n_x:
            f = torch.stack([fd(args) for fd in p.F_d])
            val = val - dt * (kq @ f)
        if n_c:
            fc = torch.stack([fcf(args) for fcf in p.F_c])
            val = val + lpq @ fc
        if n_I:
            fI = torch.stack([fi(args) for fi in p.F_I])
            # alpha is a CONSTANT here (current-point dPhi/dI): its
            # variation with (I, s) is the CG discrepancy by design
            val = val + dt * wq * (alpha @ fI)
        return val

    def psi(pv, tq):
        args, t0q, tfq = _point_args(pv, tq)
        dt = tfq - t0q
        outs = []
        if n_x:
            outs.append(dt * torch.stack([fd(args) for fd in p.F_d]))
        if n_c:
            outs.append(torch.stack([fcf(args) for fcf in p.F_c]))
        return torch.cat(outs) if outs else pv.new_zeros((0,))

    def interval_M(z_loc, Ib, tau_i, w_i, fm, fsl, qm, qsl, bc, lam_i, D_i, alpha):
        z_sub = subst(z_loc, fm, fsl, qm, qsl, bc)
        t0, tf = z_sub[i_t0], z_sub[i_tf]
        s = z_sub[s0c:]

        lam_dyn = lam_i[: n_x * dyn_rows].reshape(n_x, dyn_rows)
        lam_path = lam_i[n_x * dyn_rows :].reshape(n_c, pts_u)
        kap = lam_dyn @ Ib  # (n_x, pts_u): per-point dynamic weights

        # packed per-point arguments (pts_u, n_pt)
        cols = []
        if n_x:
            cols.append(z_sub[: n_x * pts_x].reshape(n_x, pts_x)[:, :pts_u].T)
        if n_u:
            off_u = n_x * pts_x
            cols.append(z_sub[off_u : off_u + n_u * pts_u].reshape(n_u, pts_u).T)
        cols.append(t0.expand(pts_u)[:, None])
        cols.append(tf.expand(pts_u)[:, None])
        if n_s:
            cols.append(s.expand(pts_u, n_s))
        P = torch.cat(cols, dim=1)

        phi_a = lambda pv, kq, lpq, wq, tq: phi(pv, kq, lpq, wq, tq, alpha)
        Hphi = vmap(jacfwd(grad(phi_a)))(P, kap.T, lam_path.T, w_i, tau_i)
        Gpsi = vmap(jacfwd(psi))(P, tau_i)  # (pts_u, n_f, n_pt)

        Sd = consts.get("S_cm", z_loc)
        W_sub = torch.einsum(
            "qaj,qai->ij", torch.einsum("qab,qbj->qaj", Hphi, Sd), Sd
        )
        G_loc = torch.einsum("qfa,qaj->qfj", Gpsi, Sd)

        parts = []
        if n_x:
            J_dyn = consts.get("A_lin", z_loc) - torch.einsum(
                "rq,qvc->vrc", Ib, G_loc[:, :n_x, :]
            ).reshape(n_x * dyn_rows, n_loc)
            parts.append(J_dyn)
        if n_c:
            parts.append(
                G_loc[:, n_x:, :].permute(1, 0, 2).reshape(n_c * pts_u, n_loc)
            )
        J_sub = torch.cat(parts) if parts else z_loc.new_zeros((0, n_loc))

        # substitution chain rule: z_sub[j] is a bc constant (FIXED) or
        # fn(s) (FUNC) — zero those columns; FUNC redirects into statics
        keep = 1.0 - (fm | qm).to(z_loc.dtype)
        J_t = J_sub * keep[None, :]
        W_t = W_sub * keep[None, :] * keep[:, None]

        if func_fns:
            pad_c = lambda a: torch.nn.functional.pad(a, (s0c, 0))
            pad_r = lambda a: torch.nn.functional.pad(a, (0, 0, s0c, 0))
            dfn = torch.stack([grad(fv)(s) for fv in fnvs])  # (n_fn, n_s)
            hfn = torch.stack([hessian(fv)(s) for fv in fnvs])
            Q = qm.to(z_loc.dtype)[:, None] * dfn[qsl]  # (n_loc, n_s)
            WQ = W_sub @ Q
            W_t = W_t + pad_c(keep[:, None] * WQ)
            W_t = W_t + pad_r((keep[:, None] * WQ).T)
            W_t = W_t + pad_r(pad_c(Q.T @ WQ))
            # second-order term: d2 z_sub[j] / ds2 weighted by the
            # Lagrangian gradient at the substituted column
            gphi = vmap(grad(phi_a))(P, kap.T, lam_path.T, w_i, tau_i)
            g_sub = torch.einsum("qa,qaj->j", gphi, Sd)
            if n_x:
                g_sub = g_sub + lam_dyn.reshape(-1) @ consts.get("A_lin", z_loc)
            coeff = qm.to(z_loc.dtype) * g_sub
            W_t = W_t + pad_r(pad_c(torch.einsum("j,jab->ab", coeff, hfn[qsl])))
            J_t = J_t + pad_c(J_sub @ Q)

        return W_t + torch.einsum("ri,r,rj->ij", J_t, D_i, J_t)

    return interval_M


def make_block_kkt(system) -> Optional[BlockKKT]:
    """Build the block-arrow KKT assembler for a configured system.

    Ragged interval degrees are handled by bucketing as in the reference:
    each phase's intervals are grouped by degree and group blocks embed
    into the padded ``(n_blocks, ni_max, ·)`` storage with unit diagonals
    on the phantom slots. Returns ``None`` when the layout is degenerate.
    """
    layout = structured_layout(system)
    if layout is None:
        return None

    L = int(system.L)
    n_s = system.n_s
    n_sys_rows = len(system.F_c)
    reduced = layout.reduced
    nr = len(reduced)
    red_of = {int(c): k for k, c in enumerate(reduced)}
    ni_max = layout.interior.shape[1]

    groups = []
    row0 = n_sys_rows
    b0 = 0
    for pi, p in enumerate(system.p):
        buckets: dict = {}
        for i in range(p.d.N):
            buckets.setdefault(int(p.d.num_point[i]), []).append(i)
        for deg in sorted(buckets):
            ph = _phase_interval_data(system, pi, row0, buckets[deg])
            ph["block_ids"] = b0 + ph["ivals"]
            groups.append(ph)
        row0 += p.n_x * int(p.d.L_d) + p.n_c * int(p.d.L_m)
        b0 += p.d.N
    n_blocks = b0

    for ph in groups:
        N, n_loc = ph["N"], ph["n_loc"]
        blk0 = int(ph["block_ids"][0])
        ni = int(np.sum(layout.interior[blk0] < L))
        int_sel = np.empty((N, ni), dtype=np.int64)
        red_sel_list = []
        red_pos_list = []
        for bi, b in enumerate(ph["block_ids"]):
            if np.sum(layout.interior[b] < L) != ni:
                raise ValueError("interior width varies within a degree bucket")
            loc_of = {int(c): j for j, c in enumerate(ph["local_cols"][bi])}
            int_sel[bi] = [loc_of[int(c)] for c in layout.interior[b][:ni]]
            rs, rp = [], []
            for j, c in enumerate(ph["local_cols"][bi]):
                if int(c) in red_of and j not in set(int_sel[bi]):
                    rs.append(j)
                    rp.append(red_of[int(c)])
            red_sel_list.append(rs)
            red_pos_list.append(rp)
        n_red_loc = len(red_sel_list[0])
        if any(len(r) != n_red_loc for r in red_sel_list) or ni + n_red_loc != n_loc:
            raise ValueError("inconsistent reduced-column counts across intervals")
        ph["ni"] = ni
        ph["int_sel"] = int_sel
        ph["red_sel"] = np.asarray(red_sel_list, dtype=np.int64)
        ph["red_pos"] = np.asarray(red_pos_list, dtype=np.int64)
    ids_concat = np.concatenate([ph["block_ids"] for ph in groups])
    in_order = bool(np.array_equal(ids_concat, np.arange(n_blocks)))

    if n_s:
        s_red_pos = np.array(
            [red_of[int(c)] for c in range(int(system.l_s), int(system.r_s))],
            dtype=np.int64,
        )
    else:
        s_red_pos = np.zeros((0,), dtype=np.int64)
    n_I_total = int(sum(p.n_I for p in system.p))
    F_o = system.F_o
    F_c_sys = list(system.F_c)
    l_i_of = [
        int(system.l_i[ph["pi"]]) if ph["phase"].n_I else 0 for ph in groups
    ]

    def _Phi(I_vec, s_vec, y_sys, fct_o):
        """Lagrangian head: fct_o * F_o(I, s) + y_sys . c_sys(I, s)."""
        args = [I_vec[j] for j in range(n_I_total)] + [
            s_vec[k] for k in range(n_s)
        ]
        val = fct_o * F_o(args).reshape(())
        for r, fc in enumerate(F_c_sys):
            val = val + y_sys[r] * fc(args).reshape(())
        return val

    def phi_weights(I_vec, s, y_sys, fct_o):
        """(alpha = dPhi/dI, H_ss = d2Phi/ds2) at the CURRENT point."""
        alpha = (
            grad(lambda Iv: _Phi(Iv, s, y_sys, fct_o))(I_vec)
            if n_I_total
            else I_vec.new_zeros((0,))
        )
        H_ss = (
            hessian(lambda sv: _Phi(I_vec, sv, y_sys, fct_o))(s)
            if n_s
            else I_vec.new_zeros((0, 0))
        )
        return alpha, H_ss

    fns_pt = [_make_pointwise_m(ph) for ph in groups]
    fns_iv = [_make_interval_integrals(ph) for ph in groups]

    consts = []
    for ph in groups:
        N, n_loc, ni_g = ph["N"], ph["n_loc"], ph["ni"]
        int_sel = np.asarray(ph["int_sel"])
        E_int = np.zeros((N, ni_g, n_loc))
        E_int[np.arange(N)[:, None], np.arange(ni_g)[None, :], int_sel] = 1.0
        P_red = np.zeros((N, n_loc, nr))
        P_red[np.arange(N)[:, None], ph["red_sel"], ph["red_pos"]] = 1.0
        pad = ni_max - ni_g
        consts.append(
            _ConstCache(
                local_cols=np.asarray(ph["local_cols"]),
                row_idx=np.asarray(ph["row_idx"]),
                row_w=np.asarray(ph["row_w"]),
                I=np.asarray(ph["I_blk"]),
                tau=np.asarray(ph["tau"]),
                w=np.asarray(ph["w_blk"]),
                fm=np.asarray(ph["fixed_mask"]),
                fsl=np.asarray(ph["fixed_slot"]),
                qm=np.asarray(ph["func_mask"]),
                qsl=np.asarray(ph["func_slot"]),
                E_int=E_int,
                P_red=P_red,
                pad_eye=np.diag(np.concatenate([np.zeros(ni_g), np.ones(pad)])),
            )
        )
    S_stat = np.zeros((n_s, nr))
    S_stat[np.arange(n_s), s_red_pos] = 1.0
    glob = _ConstCache(
        S_stat=S_stat,
        blk_perm=np.argsort(ids_concat) if not in_order else np.zeros(0, np.int64),
    )

    def integrals(z, rt):
        """Current values of every phase integral, ``(n_I_total,)`` in
        global integral order (a ragged phase's buckets are summed)."""
        if not n_I_total:
            return z.new_zeros((0,))
        per_phase = {}
        for ph, ivals_fn, cst in zip(groups, fns_iv, consts):
            if not ph["phase"].n_I:
                continue
            bc_p = rt["bc"][ph["pi"]].to(z.dtype)
            iv = vmap(
                lambda zl, ta, wi, fm, fsl, qm, qsl: ivals_fn(
                    zl, ta, wi, fm, fsl, qm, qsl, bc_p
                )
            )(
                z[cst.get("local_cols", z)],
                cst.get("tau", z),
                cst.get("w", z),
                cst.get("fm", z),
                cst.get("fsl", z),
                cst.get("qm", z),
                cst.get("qsl", z),
            ).sum(0)
            pi = ph["pi"]
            per_phase[pi] = per_phase[pi] + iv if pi in per_phase else iv
        return torch.cat([per_phase[pi] for pi in sorted(per_phase)])

    def assemble(z, y, D, rt, fct_o=1.0):
        """(K_ii, K_ir, K_rr) of ``W + J^T diag(D) J`` on the pattern."""
        fct_o = torch.as_tensor(fct_o, dtype=z.dtype, device=z.device)
        y_sys = y[:n_sys_rows]
        s_glob = z[int(system.l_s) : int(system.r_s)]
        I_vec = integrals(z, rt)
        alpha_all, H_ss = phi_weights(I_vec, s_glob, y_sys, fct_o)

        K_ii_parts, K_ir_parts = [], []
        K_rr = z.new_zeros((nr, nr))
        count("kkt.phase_groups", len(groups))
        for ph, ifn, cst, l_i in zip(groups, fns_pt, consts, l_i_of):
            bc = rt["bc"][ph["pi"]].to(z.dtype)
            row_idx = cst.get("row_idx", z)
            row_w = cst.get("row_w", z)
            lam_b = y[row_idx] * row_w
            D_b = D[row_idx] * row_w
            alpha_ph = alpha_all[l_i : l_i + ph["phase"].n_I]

            M = vmap(
                lambda zl, Ib, ta, wi, fm, fsl, qm, qsl, li, di: ifn(
                    zl, Ib, ta, wi, fm, fsl, qm, qsl, bc, li, di, alpha_ph
                )
            )(
                z[cst.get("local_cols", z)],
                cst.get("I", z),
                cst.get("tau", z),
                cst.get("w", z),
                cst.get("fm", z),
                cst.get("fsl", z),
                cst.get("qm", z),
                cst.get("qsl", z),
                lam_b,
                D_b,
            )

            E_i = cst.get("E_int", z)  # (N, ni_g, n_loc)
            P_r = cst.get("P_red", z)  # (N, n_loc, nr)
            Mi = torch.einsum("nai,nij->naj", E_i, M)
            K_ii_p = torch.einsum("naj,nbj->nab", Mi, E_i)
            K_ir_g = torch.einsum("naj,njr->nar", Mi, P_r)
            Mr = torch.einsum("njr,njk->nrk", P_r, M)
            K_rr = K_rr + torch.einsum("nrk,nks->rs", Mr, P_r)

            pad = ni_max - E_i.shape[1]
            if pad:
                # ragged group: embed with unit pivots on phantom slots
                K_ii_p = torch.nn.functional.pad(K_ii_p, (0, pad, 0, pad))
                K_ii_p = K_ii_p + cst.get("pad_eye", z)
                K_ir_g = torch.nn.functional.pad(K_ir_g, (0, 0, 0, pad))
            K_ii_parts.append(K_ii_p)
            K_ir_parts.append(K_ir_g)

        K_ii = torch.cat(K_ii_parts, dim=0)
        K_ir = torch.cat(K_ir_parts, dim=0)
        if not in_order:
            perm = glob.get("blk_perm", z)
            K_ii = K_ii[perm]
            K_ir = K_ir[perm]
        if n_s:
            S_s = glob.get("S_stat", z)  # (n_s, nr) one-hot
            K_rr = K_rr + S_s.T @ H_ss @ S_s
        return K_ii, K_ir, K_rr

    return BlockKKT(
        layout=layout,
        interior_pad=np.asarray(layout.interior, dtype=np.int64),
        ni_max=ni_max,
        n_blocks=n_blocks,
        assemble=assemble,
        integrals=integrals,
    )
