"""Batched error statistics for refine sweeps, on the device of the inputs.

The port of ``pockit_tpu/transcription/error.py``. The single-instance
check/refine path computes the collocation residual ``T_x_aug @ x -
I_m_aug @ f(x, u, t, s) * dt`` on the host in numpy
(``base/phase.py:_error_estimation_data_continuous``); a sweep over many
instances computes it for the whole batch at once.

:func:`make_error_stats` builds one batched torch function per system mesh
signature (the tolerances are run-time scalars) that returns only the
per-interval planning scalars the host needs:

- ``cont_ok`` (B, N): every augmented point of the interval satisfies
  ``|T_x - I_f| <= atol + rtol |I_f|`` (NaNs fail, as in the host check);
- ``ratio`` (B, N): ``max |T_x - I_f| / (1 + max |I_f|)`` over the
  interval (the p-refinement error ratio of ``plan_refine_continuous``);
- ``disc_sat`` (B, N): every bang-bang function saturated (< dtol or
  > 1 - dtol) across the whole interval.

Tiny-interval exemptions (``tolerance_mesh``) depend only on the static
mesh and stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from pockit_tpu_torch.solver.ipm import matmul_precision
from pockit_tpu_torch.transcription.compiled import _ConstCache


def _phase_error_stats(cp):
    """Per-lane error statistics of one compiled phase ``cp`` (a
    ``transcription.compiled._CompiledPhase``)."""
    phase = cp.phase
    d = phase.d
    n_x, n_u, n_s = cp.n_x, cp.n_u, cp.n_s
    N = phase.N
    c = _ConstCache(
        V_x_aug=np.asarray(d.V_x_aug), V_u_aug=np.asarray(d.V_u_aug),
        T_x_aug_v=np.asarray(d.T_x_aug_v), I_m_aug=np.asarray(d.I_m_aug),
        t_m_aug=np.asarray(d.t_m_aug), t_m=np.asarray(d.t_m),
    )
    l_aug = [int(v) for v in d.l_m_aug]
    r_aug = [int(v) for v in d.r_m_aug]
    l_m = [min(int(v), d.L_m) for v in d.l_m]
    r_m = [min(int(v), d.L_m) for v in d.r_m]
    l_v, r_v = cp._l_v, cp._r_v
    lobatto = cp._lobatto

    def stats(z_p, s, bc_vals, atol, rtol, dtol):
        z_p = cp.apply_bc(z_p, s, bc_vals)
        t0, tf = z_p[-2], z_p[-1]
        dt = tf - t0

        xs = [z_p[l_v[i] : r_v[i]] for i in range(n_x)]
        us = [z_p[l_v[n_x + i] : r_v[n_x + i]] for i in range(n_u)]
        statics = [s[i] for i in range(n_s)]

        # continuous residual on the augmented mesh
        t_aug = (c.get("t_m_aug", z_p) - 0.5) * dt + (tf + t0) / 2
        args_aug = (
            [c.get("V_x_aug", z_p) @ x for x in xs]
            + [c.get("V_u_aug", z_p) @ u for u in us]
            + [t_aug]
            + statics
        )
        T_x = torch.stack([c.get("T_x_aug_v", z_p) @ x for x in xs])
        I_m_aug = c.get("I_m_aug", z_p)
        I_f = torch.stack([I_m_aug @ fd(args_aug) for fd in phase.F_d]) * dt
        abs_err = (T_x - I_f).abs()
        ok_pt = abs_err <= atol + rtol * I_f.abs()  # NaN -> False
        cont_ok, ratio = [], []
        for i in range(N):
            a, b = l_aug[i], r_aug[i]
            cont_ok.append(ok_pt[:, a:b].all())
            scale = 1.0 + I_f[:, a:b].abs().amax(1, keepdim=True)
            ratio.append((abs_err[:, a:b] / scale).amax())
        cont_ok = torch.stack(cont_ok)
        ratio = torch.stack(ratio)

        # bang-bang saturation on the middle mesh
        if phase.n_b:
            t_mid = (c.get("t_m", z_p) - 0.5) * dt + (tf + t0) / 2
            xm = xs if lobatto else [x[:-1] for x in xs]
            f_bb = torch.stack([fb(xm + us + [t_mid] + statics) for fb in phase.F_b])
            sat = []
            for i in range(N):
                a, b = l_m[i], r_m[i]
                lo = (f_bb[:, a:b] < dtol).all(1)
                hi = (f_bb[:, a:b] > 1.0 - dtol).all(1)
                sat.append((lo | hi).all())
            disc_sat = torch.stack(sat)
        else:
            disc_sat = torch.ones((N,), dtype=torch.bool, device=z_p.device)
        return cont_ok, ratio, disc_sat

    return stats


def make_error_stats(system):
    """Build the batched error statistics of ``system`` at its CURRENT
    discretization.

    Returns ``fn(z_batch, bc, tols) -> [(cont_ok, ratio, disc_sat), ...]``
    (one triple per phase, each (B, N_phase), on the device of
    ``z_batch``); ``bc`` is a tuple of per-phase (B, n_fixed) FIXED
    boundary values as in ``ipm.solve_batch`` and ``tols = (atol, rtol,
    dtol)`` are run-time scalars. Tensors keep their device and dtype;
    numpy inputs go to ``device`` (the card unless ``device="cpu"``) in
    float64.
    """
    compiled = system.compiled
    per_phase = [_phase_error_stats(cp) for cp in compiled.phases]
    l_p, r_p = compiled.l_p, compiled.r_p
    l_s, r_s = compiled.l_s, compiled.r_s

    def one(z, bc, atol, rtol, dtol):
        s = z[l_s:r_s]
        return [
            fn(z[l_p[i] : r_p[i]], s, bc[i], atol, rtol, dtol)
            for i, fn in enumerate(per_phase)
        ]

    batched = vmap(one, in_dims=(0, 0, None, None, None))

    def fn(z_batch, bc, tols, *, device="cuda"):
        if not torch.is_tensor(z_batch):
            z_batch = torch.as_tensor(np.asarray(z_batch), dtype=torch.float64, device=device)
        bc = tuple(torch.as_tensor(v, dtype=z_batch.dtype, device=z_batch.device) for v in bc)
        atol, rtol, dtol = (float(t) for t in tols)
        # the collocation residual is a small difference of large terms:
        # no TF32 in its matmuls, as in the solver
        with matmul_precision("highest"), torch.no_grad():
            return batched(z_batch, bc, atol, rtol, dtol)

    return fn
