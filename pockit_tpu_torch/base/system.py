"""System: stitches phases + static parameters into one NLP.

API mirrors the reference ``SystemBase`` (``pockit/base/
systembase.py:50-1311``): phase factory, objective/system-constraint setters
over integral + static symbols, variable-vector layout (phases concatenated,
statics at the tail), FUNC-boundary bound promotion, bounds assembly, and
system-level check/refine delegation.

The NLP callback machinery (objective/gradient/constraints/jacobian/hessian)
is NOT incremental index bookkeeping as in the reference — it is produced by
``pockit_tpu_torch.transcription.compile_system`` as torch functions; the
``compiled`` property caches that object.
"""

from __future__ import annotations

from typing import Iterable, Optional, Self

import numpy as np
import sympy as sp

from pockit_tpu_torch.base.bc import BcType
from pockit_tpu_torch.base.expr import LoweredFunc
from pockit_tpu_torch.base.phase import PhaseBase
from pockit_tpu_torch.base.variable import VariableBase


class SystemBase:
    """The top-level objective of a multiple-phase optimal control problem."""

    _class_phase: type[PhaseBase] = PhaseBase  # overridden by scheme subclasses

    def __init__(
        self,
        static_parameter: int | list[str],
        simplify: bool = False,
        fastmath: bool = False,
    ) -> None:
        """``simplify`` / ``fastmath`` are API-parity no-ops (XLA owns both)."""
        if isinstance(static_parameter, int):
            self._num_static_parameter = static_parameter
            self._name_static_parameter = [f"s_{i}" for i in range(static_parameter)]
        elif isinstance(static_parameter, list):
            self._name_static_parameter = static_parameter
            self._num_static_parameter = len(static_parameter)
        else:
            raise ValueError(
                "static_parameter: pass a count (int) or a list of names"
            )
        self._symbol_static_parameter = [
            sp.Symbol(n) for n in self._name_static_parameter
        ]
        self._identifier_phase = 0
        self._phase_set = False
        self._objective_set = False
        self._system_constraint_set = False
        self._compiled = None
        self._nlp_structure_cache = None
        self.set_phase([])
        self.set_system_constraint([], [], [])

    # ------------------------------------------------------------------
    def new_phase(self, state, control) -> PhaseBase:
        """Create a new phase bound to this system's statics (reference:
        ``systembase.py:149-169``)."""
        self._identifier_phase += 1
        return self._class_phase(
            self._identifier_phase - 1,
            state,
            control,
            self._symbol_static_parameter,
        )

    def set_phase(self, phase: list[PhaseBase]) -> Self:
        """Bind the phases of the system."""
        for i, p in enumerate(phase):
            if not p.ok:
                raise ValueError(
                    f"phase {i} is missing required settings (dynamics, "
                    f"boundary conditions, or discretization)"
                )
        self._phase = list(phase)
        self._num_phase = len(self._phase)
        self._phase_set = True
        self._compiled = None
        self._nlp_structure_cache = None
        return self

    def set_objective(self, objective, *, cache: Optional[str] = None) -> Self:
        """Set the objective, composed of integral symbols ``I`` and statics
        ``s`` (reference: ``systembase.py:190-218``)."""
        self._expr_objective = sp.sympify(objective)
        self._objective_set = True
        self._compiled = None
        self._nlp_structure_cache = None
        return self

    def set_system_constraint(
        self,
        system_constraint: list,
        lower_bound: Iterable[float],
        upper_bound: Iterable[float],
        *,
        cache: Optional[str] = None,
    ) -> Self:
        """Set algebraic constraints over integrals and statics."""
        lower_bound = list(lower_bound)
        upper_bound = list(upper_bound)
        if not len(system_constraint) == len(lower_bound) == len(upper_bound):
            raise ValueError(
                "system_constraint, lower_bound and upper_bound are parallel "
                "lists with one entry per constraint; their lengths differ"
            )
        self._system_constraint_user = [sp.sympify(c) for c in system_constraint]
        self._system_constraint_user_lb = lower_bound
        self._system_constraint_user_ub = upper_bound
        self._system_constraint_set = True
        self._compiled = None
        self._nlp_structure_cache = None
        return self

    def update(self) -> None:
        """Invalidate compiled state after mutating a phase in place."""
        self._compiled = None
        self._nlp_structure_cache = None

    # ------------------------------------------------------------------
    # layout (reference: ``systembase.py:258-282``)
    # ------------------------------------------------------------------
    @property
    def l_p(self) -> np.ndarray:
        L = [0]
        for p in self.p[:-1]:
            L.append(L[-1] + p.L)
        return np.array(L[: self.n_p], dtype=np.int64)

    @property
    def r_p(self) -> np.ndarray:
        r, acc = [], 0
        for p in self.p:
            acc += p.L
            r.append(acc)
        return np.array(r, dtype=np.int64)

    @property
    def l_i(self) -> np.ndarray:
        L = [0]
        for p in self.p[:-1]:
            L.append(L[-1] + p.n_I)
        return np.array(L[: self.n_p], dtype=np.int64)

    @property
    def r_i(self) -> np.ndarray:
        r, acc = [], 0
        for p in self.p:
            acc += p.n_I
            r.append(acc)
        return np.array(r, dtype=np.int64)

    @property
    def l_s(self) -> int:
        return int(sum(p.L for p in self.p))

    @property
    def r_s(self) -> int:
        return self.l_s + self._num_static_parameter

    @property
    def L(self) -> int:
        """Number of optimization variables of the discretized NLP."""
        return self.r_s

    @property
    def symbols(self) -> list[sp.Symbol]:
        """Symbol table of the system level: phase integrals then statics."""
        out = []
        for p in self.p:
            out += p.I
        return out + list(self._symbol_static_parameter)

    # ------------------------------------------------------------------
    # FUNC-boundary bound promotion (reference: ``systembase.py:292-341``)
    # ------------------------------------------------------------------
    def _system_constraints_all(self):
        """User system constraints plus promoted FUNC-boundary bounds, split
        into expression rows and plain static bounds."""
        cons = list(self._system_constraint_user)
        lbs = list(self._system_constraint_user_lb)
        ubs = list(self._system_constraint_user_ub)
        for p in self.p:
            for i, lb, ub in p._variable_bounds_phase:
                if i < p.n_x and p.info_bc_0[i].t == BcType.FUNC:
                    cons.append(sp.sympify(p.bc_0[i]))
                    lbs.append(lb)
                    ubs.append(ub)
                if i < p.n_x and p.info_bc_f[i].t == BcType.FUNC:
                    cons.append(sp.sympify(p.bc_f[i]))
                    lbs.append(lb)
                    ubs.append(ub)
            for lb, ub in p._time_bounds_phase:
                if p.info_t_0.t == BcType.FUNC:
                    cons.append(sp.sympify(p.t_0))
                    lbs.append(lb)
                    ubs.append(ub)
                if p.info_t_f.t == BcType.FUNC:
                    cons.append(sp.sympify(p.t_f))
                    lbs.append(lb)
                    ubs.append(ub)

        static_bounds = []
        expr_rows, expr_lb, expr_ub = [], [], []
        for c, lb, ub in zip(cons, lbs, ubs):
            if c.is_symbol and c in self.s:
                static_bounds.append((self.s.index(c), lb, ub))
            else:
                expr_rows.append(c)
                expr_lb.append(lb)
                expr_ub.append(ub)
        return expr_rows, expr_lb, expr_ub, static_bounds

    @property
    def expr_system_constraint(self) -> list[sp.Expr]:
        return self._system_constraints_all()[0]

    @property
    def n_c(self) -> int:
        """Number of system constraint rows (incl. promoted FUNC bounds)."""
        return len(self.expr_system_constraint)

    @property
    def F_c(self) -> list[LoweredFunc]:
        rows = self.expr_system_constraint
        return [LoweredFunc(c, self.symbols) for c in rows]

    @property
    def F_o(self) -> LoweredFunc:
        return LoweredFunc(self._expr_objective, self.symbols)

    # ------------------------------------------------------------------
    # bounds (reference: ``systembase.py:554-591``)
    # ------------------------------------------------------------------
    @property
    def v_lb(self) -> np.ndarray:
        _, _, _, static_bounds = self._system_constraints_all()
        s_lb = np.full(self._num_static_parameter, -np.inf)
        for p in self.p:
            for i, lb, _ in p.s_b:
                s_lb[i] = np.maximum(s_lb[i], lb)
        for i, lb, _ in static_bounds:
            s_lb[i] = np.maximum(s_lb[i], lb)
        return np.concatenate([p.v_lb for p in self.p] + [s_lb])

    @property
    def v_ub(self) -> np.ndarray:
        _, _, _, static_bounds = self._system_constraints_all()
        s_ub = np.full(self._num_static_parameter, np.inf)
        for p in self.p:
            for i, _, ub in p.s_b:
                s_ub[i] = np.minimum(s_ub[i], ub)
        for i, _, ub in static_bounds:
            s_ub[i] = np.minimum(s_ub[i], ub)
        return np.concatenate([p.v_ub for p in self.p] + [s_ub])

    @property
    def c_lb(self) -> np.ndarray:
        _, expr_lb, _, _ = self._system_constraints_all()
        parts = [np.array(expr_lb, dtype=np.float64)]
        for p in self.p:
            parts.append(np.zeros(p.n_x * p.d.L_d))
            parts.append(np.repeat(p.c_lb, p.L_m))
        return np.concatenate(parts)

    @property
    def c_ub(self) -> np.ndarray:
        _, _, expr_ub, _ = self._system_constraints_all()
        parts = [np.array(expr_ub, dtype=np.float64)]
        for p in self.p:
            parts.append(np.zeros(p.n_x * p.d.L_d))
            parts.append(np.repeat(p.c_ub, p.L_m))
        return np.concatenate(parts)

    # ------------------------------------------------------------------
    @property
    def compiled(self):
        """The jitted transcription of this system (cached; rebuilt after
        ``update()`` / any ``set_*``)."""
        if self._compiled is None:
            from pockit_tpu_torch.transcription import compile_system

            self._compiled = compile_system(self)
        return self._compiled

    # ------------------------------------------------------------------
    # cyipopt-protocol NLP callbacks (reference: the System object is
    # itself the problem object handed to cyipopt,
    # ``pockit/base/systembase.py:602-835`` +
    # ``optimizer/ipopt.py:41-53``). Sparse methods return plain 1D value
    # arrays whose coordinates come from the matching *structure()
    # method, lower triangle only for Hessians — exactly the surface an
    # in-process real-IPOPT cross-check consumes. Dense forms remain
    # available on ``system.compiled`` (jacobian/hessian there return
    # (m, L) / (L, L) tensors). Every callback evaluates on ``device``
    # (the card unless ``device="cpu"``) and copies its result to the host.
    # ------------------------------------------------------------------
    def objective(self, x, device="cuda") -> float:
        """Objective of the discretized NLP at the flat vector ``x``."""
        return float(self.compiled.objective(np.asarray(x), device=device))

    def gradient(self, x, device="cuda") -> np.ndarray:
        """Dense objective gradient (cyipopt takes gradients dense)."""
        return self.compiled.gradient(np.asarray(x), device=device).cpu().numpy()

    def constraints(self, x, device="cuda") -> np.ndarray:
        """Constraint values, ordered [system, per phase: dynamic, path]."""
        return self.compiled.constraints(np.asarray(x), device=device).cpu().numpy()

    def _nlp_structure(self, device="cuda"):
        """Sparsity patterns (COO coordinates) of the constraint Jacobian
        and the objective/constraint Hessians, derived by evaluating the
        exact AD operators at a few generic points and taking the union
        of their nonzero supports (fixed seed; a structural entry that
        vanishes at three independent generic points has measure zero).
        The resulting Jacobian pattern is the transcription's block-arrow
        footprint: interval-local bands plus border/static columns."""
        cached = getattr(self, "_nlp_structure_cache", None)
        if cached is not None:
            return cached
        compiled = self.compiled
        rng = np.random.default_rng(20260821)
        m = compiled.m

        def union(sample):
            mask = None
            for _ in range(3):
                a = sample(rng).cpu().numpy() != 0.0
                mask = a if mask is None else (mask | a)
            return np.nonzero(mask)

        x_of = lambda rng: 0.25 + 0.5 * rng.standard_normal(self.L)
        jac_rc = union(lambda r: compiled.jacobian(x_of(r), device=device))
        hess_o_rc = union(
            lambda r: compiled.hessian(x_of(r), np.zeros(m), 1.0, device=device)
        )
        hess_c_rc = union(
            lambda r: compiled.hessian(
                x_of(r), r.standard_normal(m), 0.0, device=device
            )
        )

        def lower(rc):
            r, c = rc
            keep = r >= c
            return r[keep].astype(np.int64), c[keep].astype(np.int64)

        self._nlp_structure_cache = (
            (jac_rc[0].astype(np.int64), jac_rc[1].astype(np.int64)),
            lower(hess_o_rc),
            lower(hess_c_rc),
        )
        return self._nlp_structure_cache

    def jacobianstructure(self, device="cuda") -> tuple[np.ndarray, np.ndarray]:
        """COO coordinates of the constraint Jacobian."""
        return self._nlp_structure(device)[0]

    def jacobian(self, x, device="cuda") -> np.ndarray:
        """Constraint-Jacobian values as a plain 1D array, coordinates
        given by :meth:`jacobianstructure`."""
        rows, cols = self.jacobianstructure(device)
        J = self.compiled.jacobian(np.asarray(x), device=device).cpu().numpy()
        return J[rows, cols]

    def hessianstructure_o(self, device="cuda") -> tuple[np.ndarray, np.ndarray]:
        """COO coordinates (lower triangle) of the objective Hessian."""
        return self._nlp_structure(device)[1]

    def hessian_o(self, x, device="cuda") -> np.ndarray:
        """Objective-Hessian values at :meth:`hessianstructure_o`."""
        rows, cols = self.hessianstructure_o(device)
        m = self.compiled.m
        H = self.compiled.hessian(np.asarray(x), np.zeros(m), 1.0, device=device)
        return H.cpu().numpy()[rows, cols]

    def hessianstructure_c(self, device="cuda") -> tuple[np.ndarray, np.ndarray]:
        """COO coordinates (lower triangle) of the summed constraint
        Hessian."""
        return self._nlp_structure(device)[2]

    def hessian_c(self, x, fct_c, device="cuda") -> np.ndarray:
        """Values of ``sum_i fct_c[i] * hess(c_i)`` at
        :meth:`hessianstructure_c`."""
        rows, cols = self.hessianstructure_c(device)
        H = self.compiled.hessian(
            np.asarray(x), np.asarray(fct_c), 0.0, device=device
        )
        return H.cpu().numpy()[rows, cols]

    def hessianstructure(self, device="cuda") -> tuple[np.ndarray, np.ndarray]:
        """COO coordinates (lower triangle) of the Lagrangian Hessian:
        objective coordinates followed by constraint coordinates
        (duplicates are summed by the consumer, as cyipopt does)."""
        (ro, co), (rc_, cc_) = self._nlp_structure(device)[1:]
        return np.concatenate([ro, rc_]), np.concatenate([co, cc_])

    def hessian(self, x, fct_c, fct_o, device="cuda") -> np.ndarray:
        """Lagrangian-Hessian values ``fct_o * hess(f) + hess_c(fct_c)``
        at :meth:`hessianstructure` (objective block scaled by ``fct_o``
        followed by the constraint block)."""
        return np.concatenate(
            [
                self.hessian_o(x, device) * float(fct_o),
                self.hessian_c(x, fct_c, device),
            ]
        )

    # ------------------------------------------------------------------
    # system-level check / refine (reference: ``systembase.py:837-1234``)
    # ------------------------------------------------------------------
    def _split_value(self, value):
        value_is_variable = isinstance(value, VariableBase)
        if value_is_variable:
            value = [value]
        if not self._num_static_parameter and len(value) != self._num_phase:
            raise ValueError("expected one Variable per phase")
        if self._num_static_parameter and len(value) != self._num_phase + 1:
            raise ValueError(
                "expected one Variable per phase followed by the "
                "static-parameter values"
            )
        if self._num_static_parameter:
            s = np.array(list(value[-1]), dtype=np.float64)
            return value[:-1], s, value_is_variable, value
        return value, None, value_is_variable, value

    def check_continuous(self, value, **kw) -> bool:
        """Check the continuous error of every phase."""
        self._check_ok()
        vars_, s, _, _ = self._split_value(value)
        return bool(
            np.all([p.check_continuous(v, s, **kw) for p, v in zip(self.p, vars_)])
        )

    def check_discontinuous(self, value, **kw) -> bool:
        """Check the discontinuous (bang-bang) error of every phase."""
        self._check_ok()
        vars_, s, _, _ = self._split_value(value)
        return bool(
            np.all([p.check_discontinuous(v, s, **kw) for p, v in zip(self.p, vars_)])
        )

    def check(
        self,
        value,
        absolute_tolerance_continuous: float = 1.0e-8,
        relative_tolerance_continuous: float = 1.0e-8,
        tolerance_discontinuous: float = 1.0e-3,
        tolerance_mesh: float = 1.0e-4,
    ) -> bool:
        """Check both error measures of every phase."""
        return self.check_continuous(
            value,
            absolute_tolerance_continuous=absolute_tolerance_continuous,
            relative_tolerance_continuous=relative_tolerance_continuous,
            tolerance_mesh=tolerance_mesh,
        ) and self.check_discontinuous(
            value,
            tolerance_discontinuous=tolerance_discontinuous,
            tolerance_mesh=tolerance_mesh,
        )

    def _refine_with(self, value, refine_name, check_name, check_kw, refine_kw):
        self._check_ok()
        if getattr(self, check_name)(value, **check_kw):
            return value
        vars_, s, value_is_variable, orig = self._split_value(value)
        adapted = []
        for p, v in zip(self.p, vars_):
            getattr(p, refine_name)(v, s, **refine_kw)
            adapted.append(v.adapt(p))
        self.update()
        if value_is_variable:
            return adapted[0]
        if len(adapted) == len(orig):
            return adapted
        return adapted + [orig[-1]]

    def refine_continuous(
        self,
        value,
        absolute_tolerance_continuous: float = 1.0e-8,
        relative_tolerance_continuous: float = 1.0e-8,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1.0e-3,
        mesh_length_max: float = 1.0,
    ):
        """Refine all phases for the continuous error; returns adapted
        variables."""
        return self._refine_with(
            value,
            "refine_continuous",
            "check_continuous",
            dict(
                absolute_tolerance_continuous=absolute_tolerance_continuous,
                relative_tolerance_continuous=relative_tolerance_continuous,
                tolerance_mesh=mesh_length_min,
            ),
            dict(
                absolute_tolerance_continuous=absolute_tolerance_continuous,
                relative_tolerance_continuous=relative_tolerance_continuous,
                num_point_min=num_point_min,
                num_point_max=num_point_max,
                mesh_length_min=mesh_length_min,
                mesh_length_max=mesh_length_max,
            ),
        )

    def refine_discontinuous(
        self,
        value,
        tolerance_discontinuous: float = 1.0e-3,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1.0e-3,
        mesh_length_max: float = 1.0,
    ):
        """Refine all phases for the bang-bang error; returns adapted
        variables."""
        return self._refine_with(
            value,
            "refine_discontinuous",
            "check_discontinuous",
            dict(
                tolerance_discontinuous=tolerance_discontinuous,
                tolerance_mesh=mesh_length_min,
            ),
            dict(
                tolerance_discontinuous=tolerance_discontinuous,
                num_point_min=num_point_min,
                num_point_max=num_point_max,
                mesh_length_min=mesh_length_min,
                mesh_length_max=mesh_length_max,
            ),
        )

    def refine(
        self,
        value,
        absolute_tolerance_continuous: float = 1.0e-8,
        relative_tolerance_continuous: float = 1.0e-8,
        tolerance_discontinuous: float = 1.0e-3,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1.0e-3,
        mesh_length_max: float = 1.0,
    ):
        """Refine all phases (discontinuous-first policy per phase); returns
        adapted variables."""
        return self._refine_with(
            value,
            "refine",
            "check",
            dict(
                absolute_tolerance_continuous=absolute_tolerance_continuous,
                relative_tolerance_continuous=relative_tolerance_continuous,
                tolerance_discontinuous=tolerance_discontinuous,
                tolerance_mesh=mesh_length_min,
            ),
            dict(
                absolute_tolerance_continuous=absolute_tolerance_continuous,
                relative_tolerance_continuous=relative_tolerance_continuous,
                tolerance_discontinuous=tolerance_discontinuous,
                num_point_min=num_point_min,
                num_point_max=num_point_max,
                mesh_length_min=mesh_length_min,
                mesh_length_max=mesh_length_max,
            ),
        )

    def _check_ok(self):
        if not self.ok:
            raise ValueError(
                "system setup is incomplete: set phases and an objective first"
            )

    # ------------------------------------------------------------------
    @property
    def n_s(self) -> int:
        """Number of static parameters."""
        return self._num_static_parameter

    @property
    def s(self) -> list[sp.Symbol]:
        """Symbols of static parameters."""
        return self._symbol_static_parameter

    @property
    def n_p(self) -> int:
        """Number of phases."""
        return self._num_phase

    @property
    def N(self) -> int:
        return self._num_phase

    @property
    def p(self) -> list[PhaseBase]:
        """Phases of the system."""
        return self._phase

    @property
    def ok(self) -> bool:
        """Whether the system is fully configured."""
        return self._phase_set and self._objective_set and self._system_constraint_set
