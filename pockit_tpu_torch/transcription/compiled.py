"""Compile a configured ``System`` into per-lane torch NLP functions.

The port of ``pockit_tpu/transcription/compiled.py``:

- Boundary conditions are *substituted into the vector* at the head of every
  evaluation (out of place, with ``torch.where`` over static masks, so
  ``torch.func.vmap`` and ``grad`` compose through it); gradients through
  FIXED entries vanish and FUNC entries chain into the static parameters.
- Dynamic residuals are dense matmuls ``X @ T_vᵀ - dt · f(V) @ I_mᵀ``.
- Derivatives come from ``torch.func`` (``grad`` / ``jacrev`` / ``hessian``).

Constraint ordering matches the reference NLP exactly: system rows first,
then per phase the dynamic rows (state-major) followed by path rows
(constraint-major, all collocation points).

``objective_fn`` / ``constraints_fn`` act on ONE lane: ``z (L,)`` and a
runtime dict ``rt = {"bc": (one (n_fixed,) tensor per phase)}``. The solver
batches them with ``torch.func.vmap``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, jacrev

from pockit_tpu_torch.base.bc import BcType
from pockit_tpu_torch.base.expr import host_constant, is_cacheable


class _ConstCache:
    """Numpy constants cast once per (dtype, device) instead of on every
    evaluation (a host-to-device copy each time on the card).

    Each is made outside every ``torch.func`` level
    (:func:`~pockit_tpu_torch.base.expr.host_constant`), so one made inside
    ``grad`` / ``jvp`` is cached too; one made while ``torch.export``
    traces is used once and not cached
    (:func:`~pockit_tpu_torch.base.expr.is_cacheable`)."""

    def __init__(self, **arrays):
        self._np = arrays
        self._t = {}

    def get(self, name, like: torch.Tensor):
        key = (name, like.dtype, like.device)
        t = self._t.get(key)
        if t is None:
            a = self._np[name]
            dt = like.dtype if np.issubdtype(a.dtype, np.floating) else None
            t = host_constant(a, dtype=dt, device=like.device)
            if is_cacheable(t):
                self._t[key] = t
        return t


class _CompiledPhase:
    """Static data + evaluation closure for one phase."""

    def __init__(self, phase):
        d = phase.d
        self.phase = phase
        self.L = d.L
        self.L_m = d.L_m
        self.n_x, self.n_u, self.n_s = phase.n_x, phase.n_u, phase.n_s
        self.n_I, self.n_c = phase.n_I, phase.n_c
        self.n_dyn_rows = phase.n_x * d.L_d
        self.n_path_rows = phase.n_c * d.L_m
        self._l_v = [int(v) for v in d.l_v]
        self._r_v = [int(v) for v in d.r_v]
        self._lobatto = d.family == "lobatto"

        # classify boundary-condition slots
        fixed_idx, fixed_vals, func_bcs = [], [], []
        slots = (
            [(int(self._l_v[i]), phase.info_bc_0[i]) for i in range(self.n_x)]
            + [(int(self._r_v[i] - 1), phase.info_bc_f[i]) for i in range(self.n_x)]
            + [(self.L - 2, phase.info_t_0), (self.L - 1, phase.info_t_f)]
        )
        for idx, info in slots:
            if info.t == BcType.FIXED:
                fixed_idx.append(idx)
                fixed_vals.append(float(info.v))
            elif info.t == BcType.FUNC:
                func_bcs.append((idx, info.v))
        # pinned (lb == ub) variables: parameter substitution through the
        # same runtime bc vector, appended AFTER the boundary-condition
        # slots (the reference's bc_overrides index convention)
        bc_owned = set(fixed_idx) | {i for i, _ in func_bcs}
        fixed_by_idx = dict(zip(fixed_idx, fixed_vals))
        for idx, val in phase.pinned_variable_slots:
            if idx not in bc_owned:
                fixed_idx.append(idx)
                fixed_vals.append(val)
            elif idx in fixed_by_idx and fixed_by_idx[idx] != val:
                raise ValueError(
                    f"phase variable slot {idx} is pinned to {val} by an "
                    "equal-bound phase constraint but its boundary "
                    f"condition fixes it to {fixed_by_idx[idx]}; the "
                    "problem is infeasible"
                )
        self.fixed_idx = np.array(fixed_idx, dtype=np.int32)
        self.fixed_vals = np.array(fixed_vals, dtype=np.float64)
        self.func_bcs = func_bcs

        # substitution as a gather + select: slot j takes bc[fixed_slot[j]]
        # where fixed_mask[j]
        fixed_mask = np.zeros(self.L, dtype=bool)
        fixed_slot = np.zeros(self.L, dtype=np.int64)
        fixed_mask[self.fixed_idx] = True
        fixed_slot[self.fixed_idx] = np.arange(len(self.fixed_idx))
        func_masks = np.zeros((len(func_bcs), self.L), dtype=bool)
        for k, (idx, _) in enumerate(func_bcs):
            func_masks[k, idx] = True
        self._c = _ConstCache(
            T_v=d.T_v, I_m=d.I_m, w_m=d.w_m, t_m=d.t_m,
            fixed_mask=fixed_mask, fixed_slot=fixed_slot, func_masks=func_masks,
        )

    def apply_bc(self, z_p, s, bc_vals):
        """Substitute FIXED (from runtime ``bc_vals``) and FUNC (computed
        from statics) boundary values into the phase vector."""
        if len(self.fixed_idx):
            bc = bc_vals.to(z_p.dtype)
            z_p = torch.where(
                self._c.get("fixed_mask", z_p),
                bc[self._c.get("fixed_slot", z_p)],
                z_p,
            )
        if self.func_bcs:
            masks = self._c.get("func_masks", z_p)
            for k, (_, fn) in enumerate(self.func_bcs):
                z_p = torch.where(masks[k], fn(list(s)), z_p)
        return z_p

    def evaluate(self, z_p, s, bc_vals):
        """Return ``(dyn_residual, path_values, integrals)`` of the phase."""
        p = self.phase
        z_p = self.apply_bc(z_p, s, bc_vals)
        t0, tf = z_p[-2], z_p[-1]
        dt = tf - t0
        t_m = self._c.get("t_m", z_p)
        t_mid = (t_m - 0.5) * dt + (tf + t0) / 2

        xs = [z_p[self._l_v[i] : self._r_v[i]] for i in range(self.n_x)]
        us = [
            z_p[self._l_v[self.n_x + i] : self._r_v[self.n_x + i]]
            for i in range(self.n_u)
        ]
        xm = xs if self._lobatto else [x[:-1] for x in xs]
        args = xm + us + [t_mid] + [s[i] for i in range(self.n_s)]

        empty = z_p.new_zeros((0,))
        if self.n_x:
            T_v = self._c.get("T_v", z_p)
            I_m = self._c.get("I_m", z_p)
            f = torch.stack([fd(args) for fd in p.F_d])  # (n_x, L_m)
            X = torch.stack(xs)  # (n_x, L_x_var)
            dyn = (X @ T_v.T - dt * (f @ I_m.T)).reshape(-1)
        else:
            dyn = empty

        path = torch.cat([fc(args) for fc in p.F_c]) if self.n_c else empty

        if self.n_I:
            w_m = self._c.get("w_m", z_p)
            integrals = torch.stack([fI(args) @ w_m for fI in p.F_I]) * dt
        else:
            integrals = empty
        return dyn, path, integrals


class CompiledSystem:
    """Torch NLP view of a configured system.

    ``objective_fn`` / ``constraints_fn`` take one lane's flat system vector
    ``z`` (phases concatenated, statics at the tail) and a runtime dict
    ``rt`` carrying that lane's FIXED boundary values. The host-facing
    ``objective`` / ``gradient`` / ``constraints`` / ``jacobian`` /
    ``hessian`` take numpy and return dense float64 CPU tensors.
    """

    def __init__(self, system):
        self.system = system
        self.phases = [_CompiledPhase(p) for p in system.p]
        self.L = system.L
        self.n_s = system.n_s
        self.l_p = [int(v) for v in system.l_p]
        self.r_p = [int(v) for v in system.r_p]
        self.l_s, self.r_s = system.l_s, system.r_s

        self._F_o = system.F_o
        self._F_c_sys = system.F_c
        self.n_sys_rows = len(self._F_c_sys)
        self.m = self.n_sys_rows + sum(
            cp.n_dyn_rows + cp.n_path_rows for cp in self.phases
        )

        # bounds (host numpy; the solver consumes these)
        self.z_lb = system.v_lb
        self.z_ub = system.v_ub
        self.c_lb = system.c_lb
        self.c_ub = system.c_ub

    # -- runtime dict ----------------------------------------------------
    def default_runtime(self, device="cuda", dtype=torch.float64):
        """Default runtime data: the FIXED boundary values as configured,
        on ``device`` (the card unless ``device="cpu"``)."""
        return {
            "bc": tuple(
                torch.as_tensor(cp.fixed_vals, dtype=dtype, device=device)
                for cp in self.phases
            )
        }

    # -- core evaluations ------------------------------------------------
    def _eval_all(self, z, rt):
        s = z[self.l_s : self.r_s]
        dyns, paths, integrals = [], [], []
        for i, cp in enumerate(self.phases):
            z_p = z[self.l_p[i] : self.r_p[i]]
            dyn, path, I = cp.evaluate(z_p, s, rt["bc"][i])
            dyns.append(dyn)
            paths.append(path)
            integrals.append(I)
        I_all = torch.cat(integrals) if integrals else z.new_zeros((0,))
        sys_args = [I_all[j] for j in range(I_all.shape[0])] + [
            s[k] for k in range(self.n_s)
        ]
        return sys_args, dyns, paths

    def objective_fn(self, z, rt):
        """Per-lane objective (0-d tensor)."""
        sys_args, _, _ = self._eval_all(z, rt)
        return self._F_o(sys_args).reshape(())

    def constraints_fn(self, z, rt):
        """Per-lane constraints, ordered [system, per phase: dynamic, path]."""
        sys_args, dyns, paths = self._eval_all(z, rt)
        if self.n_sys_rows:
            sys_rows = torch.stack(
                [fc(sys_args).reshape(()) for fc in self._F_c_sys]
            )
        else:
            sys_rows = z.new_zeros((0,))
        parts = [sys_rows]
        for dyn, path in zip(dyns, paths):
            parts.append(dyn)
            parts.append(path)
        return torch.cat(parts)

    def lagrangian_fn(self, z, lam_c, fct_o, rt):
        """``fct_o * f(z) + lam_c @ c(z)`` (bound terms excluded)."""
        return fct_o * self.objective_fn(z, rt) + self.constraints_fn(z, rt) @ lam_c

    # -- dense evaluations at one point ------------------------------------
    # Each takes array-likes, evaluates in float64 on ``device`` (the card
    # unless ``device="cpu"``; ``rt``'s tensors must lie there too) and
    # returns a tensor on it.
    @staticmethod
    def _t(a, device):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    def objective(self, z, rt=None, device="cuda"):
        return self.objective_fn(self._t(z, device), rt or self.default_runtime(device))

    def gradient(self, z, rt=None, device="cuda"):
        return grad(self.objective_fn)(self._t(z, device), rt or self.default_runtime(device))

    def constraints(self, z, rt=None, device="cuda"):
        return self.constraints_fn(self._t(z, device), rt or self.default_runtime(device))

    def jacobian(self, z, rt=None, device="cuda"):
        """Dense (m, L) constraint Jacobian."""
        return jacrev(self.constraints_fn)(self._t(z, device), rt or self.default_runtime(device))

    def hessian(self, z, lam_c, fct_o, rt=None, device="cuda"):
        """Dense (L, L) Hessian of ``fct_o * f + lam_c @ c``."""
        return hessian(self.lagrangian_fn)(
            self._t(z, device),
            self._t(lam_c, device),
            self._t(fct_o, device),
            rt or self.default_runtime(device),
        )


def compile_system(system) -> CompiledSystem:
    """Lower a fully configured ``System`` into torch NLP functions."""
    if not system.ok:
        raise ValueError(
            "system setup is incomplete: set phases and an objective first"
        )
    return CompiledSystem(system)
