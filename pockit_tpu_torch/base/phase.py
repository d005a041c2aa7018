"""Phase: one trajectory segment of a multi-phase optimal control problem.

API mirrors the reference ``PhaseBase`` (``pockit/base/
phasebase.py:38-2306``): symbolic declaration of dynamics, integrals, path
constraints, boundary conditions and the collocation mesh, plus error
estimation and hp-adaptive mesh refinement.

Architectural difference from the reference: no AutoUpdate dependency DAG
and no per-setter kernel compilation. Expressions are lowered to torch
callables immediately (cheap); all derivative machinery lives in
``pockit_tpu_torch.transcription`` via ``torch.func``.
"""

from __future__ import annotations

import itertools as it
from typing import Iterable, Optional, Sequence

import numpy as np
import sympy as sp

from pockit_tpu_torch.base.bc import BcInfo, BcType, parse_boundary_condition
from pockit_tpu_torch.base.discretization import Discretization
from pockit_tpu_torch.base.expr import LoweredFunc


class PhaseBase:
    """A phase is a lower-level objective of a multiple-phase optimal control
    problem."""

    _family: str = ""  # set by scheme subclasses ('lobatto' / 'radau')

    def __init__(
        self,
        identifier: int,
        state: int | list[str],
        control: int | list[str],
        symbol_static_parameter: list[sp.Symbol],
        simplify: bool = False,
        fastmath: bool = False,
    ) -> None:
        """``simplify`` / ``fastmath`` are accepted for API parity with the
        reference but are no-ops: XLA owns simplification and fast-math."""
        self._identifier = identifier

        if isinstance(state, int):
            self._num_state = state
            self._name_state = [f"x_{i}^{{({identifier})}}" for i in range(state)]
        elif isinstance(state, list):
            if "t" in state:
                raise ValueError(
                    '"t" is the time symbol; '
                    "pick a different name for the state variables"
                )
            self._name_state = [s + f"^{{({identifier})}}" for s in state]
            self._num_state = len(state)
        else:
            raise ValueError("state: pass a count (int) or a list of names")

        if isinstance(control, int):
            self._num_control = control
            self._name_control = [f"u_{i}^{{({identifier})}}" for i in range(control)]
        elif isinstance(control, list):
            if "t" in control:
                raise ValueError(
                    '"t" is the time symbol; '
                    "pick a different name for the control variables"
                )
            self._name_control = [c + f"^{{({identifier})}}" for c in control]
            self._num_control = len(control)
        else:
            raise ValueError("control: pass a count (int) or a list of names")

        self._num_variable = self._num_state + self._num_control
        self._num_static_parameter = len(symbol_static_parameter)
        self._symbol_static_parameter = list(symbol_static_parameter)

        self._symbol_state = [sp.Symbol(n) for n in self._name_state]
        self._symbol_control = [sp.Symbol(n) for n in self._name_control]
        self._symbol_time = sp.Symbol(f"t^{{({identifier})}}")
        self._symbols = (
            self._symbol_state
            + self._symbol_control
            + [self._symbol_time]
            + self._symbol_static_parameter
        )

        self._dynamics_set = False
        self._boundary_condition_set = False
        self._discretization_set = False
        self._discontinuous_check_passed = False
        self._object_discretization: Optional[Discretization] = None

        self.set_integral([])
        self.set_phase_constraint([], [], [])

    # ------------------------------------------------------------------
    # setters
    # ------------------------------------------------------------------
    def _lower(self, expr) -> LoweredFunc:
        return LoweredFunc(expr, self._symbols)

    def set_dynamics(self, dynamics: list, *, cache: Optional[str] = None):
        """Set time derivatives of the states, composed of x, u, t, s
        (reference: ``phasebase.py:243-273``). ``cache`` is a no-op."""
        if len(dynamics) != self.n_x:
            raise ValueError(
                f"set_dynamics expects one expression per state variable "
                f"({self.n_x}), got {len(dynamics)}"
            )
        self._expr_dynamics = [sp.sympify(d) for d in dynamics]
        self._func_dynamics = [self._lower(d) for d in self._expr_dynamics]
        self._dynamics_set = True
        self._discontinuous_check_passed = False
        return self

    def set_integral(self, integral: list, *, cache: Optional[str] = None):
        """Set the integrals of the phase; symbols ``I_i`` are generated and
        exposed as :attr:`I` (reference: ``phasebase.py:275-309``)."""
        self._num_integral = len(integral)
        self._expr_integral = [sp.sympify(i) for i in integral]
        self._func_integral = [self._lower(i) for i in self._expr_integral]
        self._symbol_integral = [
            sp.Symbol(f"I_{i}^{{({self._identifier})}}")
            for i in range(self._num_integral)
        ]
        self._discontinuous_check_passed = False
        return self

    def set_phase_constraint(
        self,
        phase_constraint: list,
        lower_bound: list,
        upper_bound: list,
        bang_bang_control: bool | list[bool] = False,
        *,
        cache: Optional[str] = None,
    ):
        """Set path constraints enforced over the whole phase. Plain-symbol
        constraints become variable/time/static bounds instead of NLP rows
        (reference: ``phasebase.py:311-418``)."""
        phase_constraint = list(phase_constraint)
        lower_bound = list(lower_bound)
        upper_bound = list(upper_bound)
        if not len(phase_constraint) == len(lower_bound) == len(upper_bound):
            raise ValueError(
                "phase_constraint, lower_bound and upper_bound are parallel "
                "lists with one entry per constraint; their lengths differ"
            )

        self._variable_bounds_phase = []
        self._static_parameter_bounds_phase = []
        self._time_bounds_phase = []
        self._expr_phase_constraint = []
        lbs, ubs = [], []
        for c, lb, ub in zip(phase_constraint, lower_bound, upper_bound):
            c = sp.sympify(c)
            if c.is_symbol:
                i = self._symbols.index(c)
                if i < self._num_variable:
                    self._variable_bounds_phase.append((i, lb, ub))
                elif i == self._num_variable:
                    self._time_bounds_phase.append((lb, ub))
                else:
                    self._static_parameter_bounds_phase.append(
                        (i - self._num_variable - 1, lb, ub)
                    )
            else:
                self._expr_phase_constraint.append(c)
                lbs.append(lb)
                ubs.append(ub)

        # a pin (lb == ub) is substituted as a parameter, so a second
        # entry boxing the same variable would otherwise be silently
        # overruled — but a pin outside that box (or two different pins)
        # makes the problem infeasible, which the reference's equality-row
        # treatment would report at solve time; detect it here instead
        by_var: dict = {}
        for i, lb, ub in self._variable_bounds_phase:
            by_var.setdefault(i, []).append((lb, ub))
        for i, entries in by_var.items():
            pins = [float(lb) for lb, ub in entries if self._is_pin(lb, ub)]
            if not pins:
                continue
            name = self._symbols[i]
            if len(set(pins)) > 1:
                raise ValueError(
                    f"variable {name} is pinned to conflicting values "
                    f"{sorted(set(pins))}; the problem is infeasible"
                )
            pin = pins[0]
            for lb, ub in entries:
                if self._is_pin(lb, ub):
                    continue
                lo = -np.inf if lb is None else float(lb)
                hi = np.inf if ub is None else float(ub)
                if pin < lo or pin > hi:
                    raise ValueError(
                        f"variable {name} is pinned to {pin} but another "
                        f"constraint bounds it to [{lo}, {hi}]; the "
                        "problem is infeasible"
                    )

        self._num_phase_constraint = len(self._expr_phase_constraint)
        self._func_phase_constraint = [
            self._lower(c) for c in self._expr_phase_constraint
        ]
        self._lower_bound_phase_constraint = np.array(lbs, dtype=np.float64)
        self._upper_bound_phase_constraint = np.array(ubs, dtype=np.float64)

        # bang-bang constraints, scaled to [0, 1]
        if isinstance(bang_bang_control, bool):
            bang_bang_control = it.repeat(bang_bang_control)
        self._func_bang_bang_control = []
        for expr, lb, ub, bb in zip(
            phase_constraint, lower_bound, upper_bound, bang_bang_control
        ):
            if bb:
                if np.isinf(lb) or np.isinf(ub):
                    raise ValueError(
                        "bang-bang control constraints need finite lower and "
                        "upper bounds"
                    )
                if ub <= lb + 1e-10:
                    raise ValueError(
                        "bang-bang control constraints need "
                        "upper_bound > lower_bound"
                    )
                self._func_bang_bang_control.append(
                    self._lower((sp.sympify(expr) - lb) / (ub - lb))
                )
        self._num_bang_bang = len(self._func_bang_bang_control)
        self._discontinuous_check_passed = False
        return self

    def set_boundary_condition(
        self,
        initial_value: list,
        terminal_value: list,
        initial_time,
        terminal_time,
        *,
        cache: Optional[str] = None,
    ):
        """Set boundary conditions: ``None`` = free, number = fixed,
        sympy expression of statics = FUNC (reference: ``phasebase.py:440-512``)."""
        initial_value = list(initial_value)
        terminal_value = list(terminal_value)
        if not len(initial_value) == len(terminal_value) == self.n_x:
            raise ValueError(
                "boundary conditions take one initial_value and one "
                "terminal_value entry per state variable"
            )
        self._initial_value = initial_value
        self._terminal_value = terminal_value
        self._initial_time = initial_time
        self._terminal_time = terminal_time

        ss = self._symbol_static_parameter
        self.info_bc_0 = [parse_boundary_condition(b, ss) for b in initial_value]
        self.info_bc_f = [parse_boundary_condition(b, ss) for b in terminal_value]
        self.info_t_0 = parse_boundary_condition(initial_time, ss)
        self.info_t_f = parse_boundary_condition(terminal_time, ss)

        self._boundary_condition_set = True
        self._discontinuous_check_passed = False
        return self

    def set_discretization(self, mesh, num_point):
        """Set the collocation mesh; int = uniform mesh / uniform degree
        (reference: ``phasebase.py:514-601``)."""
        if isinstance(mesh, int):
            self._mesh = np.linspace(0, 1, mesh + 1, endpoint=True)
        else:
            mesh = np.array(list(mesh), dtype=np.float64)
            self._mesh = (mesh - mesh[0]) / (mesh[-1] - mesh[0])
        self._num_interval = len(self._mesh) - 1
        if isinstance(num_point, (int, np.integer)):
            self._num_point = np.full(self._num_interval, num_point, dtype=np.int64)
        else:
            self._num_point = np.array(list(num_point), dtype=np.int64)
        if len(self._num_point) != self._num_interval:
            raise ValueError(
                "one num_point entry is required per mesh subinterval "
                "(a length of len(mesh) - 1)"
            )
        self._object_discretization = Discretization(
            self._family, self._mesh, self._num_point, self.n_x, self.n_u
        )
        self._discretization_set = True
        self._discontinuous_check_passed = False
        return self

    # ------------------------------------------------------------------
    # host-side evaluation helpers (numpy; used by check/refine and
    # post-processing — the device path lives in transcription/)
    # ------------------------------------------------------------------
    @staticmethod
    def _value_boundary_condition(info: BcInfo, x, s):
        if info.t == BcType.FREE:
            return x
        if info.t == BcType.FIXED:
            return info.v
        return float(np.asarray(info.v(list(s))))

    def _apply_bc_host(self, x: np.ndarray, s: np.ndarray) -> np.ndarray:
        """Substitute boundary conditions into a phase vector (host copy)."""
        x = np.array(x, dtype=np.float64)
        # pins first so boundary conditions (more specific) win at the
        # overlapping first/last slots of a pinned state
        for idx, val in self.pinned_variable_slots:
            x[idx] = val
        for i, info in enumerate(self.info_bc_0):
            x[self.l_v[i]] = self._value_boundary_condition(info, x[self.l_v[i]], s)
        for i, info in enumerate(self.info_bc_f):
            x[self.r_v[i] - 1] = self._value_boundary_condition(
                info, x[self.r_v[i] - 1], s
            )
        x[-2] = self._value_boundary_condition(self.info_t_0, x[-2], s)
        x[-1] = self._value_boundary_condition(self.info_t_f, x[-1], s)
        return x

    def _middle_args_host(self, x: np.ndarray, s: np.ndarray, aug: bool):
        """Evaluate-ready argument list at the (augmented) middle stage."""
        d = self._object_discretization
        t0, tf = x[-2], x[-1]
        dt = tf - t0
        t_nodes = d.t_m_aug if aug else d.t_m
        t_phys = (t_nodes - 0.5) * dt + (tf + t0) / 2
        args = []
        for i in range(self.n_x):
            xv = x[self.l_v[i] : self.r_v[i]]
            args.append(
                np.asarray(d.V_x_aug @ xv) if aug else np.asarray(d.state_to_mid(xv))
            )
        for i in range(self.n_u):
            uv = x[self.l_v[self.n_x + i] : self.r_v[self.n_x + i]]
            args.append(np.asarray(d.V_u_aug @ uv) if aug else uv)
        args.append(t_phys)
        for si in s:
            args.append(np.full(len(t_phys), si))
        return args, dt

    def _error_estimation_data_continuous(self, x, s):
        """Residual data on the augmented mesh (reference:
        ``phasebase.py:1316-1327``)."""
        d = self._object_discretization
        x = self._apply_bc_host(x, s)
        args, dt = self._middle_args_host(x, s, aug=True)
        T_x = np.stack(
            [d.T_x_aug_v @ x[self.l_v[i] : self.r_v[i]] for i in range(self.n_x)]
        )
        I_f = (
            np.stack([d.I_m_aug @ np.asarray(f(args)) for f in self._func_dynamics])
            * dt
        )
        return T_x, I_f

    def _error_estimation_data_discontinuous(self, x, s):
        if not self.n_b:
            return np.zeros((0, self.L_m))
        x = self._apply_bc_host(x, s)
        args, _ = self._middle_args_host(x, s, aug=False)
        return np.stack([np.asarray(f(args)) for f in self._func_bang_bang_control])

    @staticmethod
    def _segment_count(flags: np.ndarray, l_idx, r_idx) -> np.ndarray:
        """Count True flags inside each ``[l, r)`` point segment via one
        cumulative sum (vectorized over segments; last axis is points)."""
        cum = np.concatenate(
            [np.zeros(flags.shape[:-1] + (1,), dtype=np.int64),
             np.cumsum(flags, axis=-1)],
            axis=-1,
        )
        # segment bounds may overhang the point grid (slice-clip semantics)
        l_idx = np.minimum(np.asarray(l_idx), flags.shape[-1])
        r_idx = np.minimum(np.asarray(r_idx), flags.shape[-1])
        return cum[..., r_idx] - cum[..., l_idx]

    def _tiny_intervals(self, mtol: float) -> np.ndarray:
        """Intervals narrower than ``mtol`` are exempt from error checks."""
        m = np.asarray(self._mesh)
        return (m[1:] - m[:-1]) < mtol

    def _error_check_interval_continuous(self, T_x, I_f, atol, rtol, mtol):
        """Per-interval residual acceptance: every augmented point of the
        interval must satisfy ``|T_x - I_f| <= atol + rtol |I_f|``."""
        with np.errstate(invalid="ignore"):
            bad = ~np.all(
                np.abs(T_x - I_f) <= atol + rtol * np.abs(I_f), axis=0
            )  # NaN residuals count as failures, matching np.allclose
        n_bad = self._segment_count(bad, self.l_m_aug, self.r_m_aug)
        return (n_bad == 0) | self._tiny_intervals(mtol)

    def _error_check_interval_discontinuous(self, f_bb, dtol, mtol):
        """Per-interval saturation acceptance: each bang-bang function must
        sit entirely below ``dtol`` or entirely above ``1 - dtol`` on every
        interval."""
        if not self.n_b:
            return np.ones(self.N, dtype=bool)
        L_pts = f_bb.shape[-1]
        widths = np.minimum(self.r_m, L_pts) - np.minimum(self.l_m, L_pts)
        n_low = self._segment_count(f_bb < dtol, self.l_m, self.r_m)
        n_high = self._segment_count(f_bb > 1.0 - dtol, self.l_m, self.r_m)
        saturated = (n_low == widths) | (n_high == widths)  # (n_b, N)
        return saturated.all(axis=0) | self._tiny_intervals(mtol)

    # ------------------------------------------------------------------
    # check / refine (reference: ``phasebase.py:1362-1891``)
    # ------------------------------------------------------------------
    def check_continuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        absolute_tolerance_continuous: float = 1e-8,
        relative_tolerance_continuous: float = 1e-8,
        tolerance_mesh: float = 1e-4,
    ) -> bool:
        """Check the collocation-residual (continuous) error."""
        s = self._require_static(static_parameter)
        T_x, I_f = self._error_estimation_data_continuous(variable.data, s)
        ec = self._error_check_interval_continuous(
            T_x,
            I_f,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            tolerance_mesh,
        )
        return bool(np.all(ec))

    def check_discontinuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        tolerance_discontinuous: float = 1e-3,
        tolerance_mesh: float = 1e-4,
    ) -> bool:
        """Check the bang-bang saturation (discontinuous) error."""
        s = self._require_static(static_parameter)
        f_bb = self._error_estimation_data_discontinuous(variable.data, s)
        ec = self._error_check_interval_discontinuous(
            f_bb, tolerance_discontinuous, tolerance_mesh
        )
        passed = bool(np.all(ec))
        if passed:
            self._discontinuous_check_passed = True
        return passed

    def check(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        absolute_tolerance_continuous: float = 1e-8,
        relative_tolerance_continuous: float = 1e-8,
        tolerance_discontinuous: float = 1e-3,
        tolerance_mesh: float = 1e-4,
    ) -> bool:
        """Check both error measures (reference: ``phasebase.py:1437-1481``)."""
        if self._discontinuous_check_passed:
            return self.check_continuous(
                variable,
                static_parameter,
                absolute_tolerance_continuous,
                relative_tolerance_continuous,
                tolerance_mesh,
            )
        return self.check_discontinuous(
            variable, static_parameter, tolerance_discontinuous, tolerance_mesh
        ) and self.check_continuous(
            variable,
            static_parameter,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            tolerance_mesh,
        )

    def _require_static(self, static_parameter):
        if self._num_static_parameter and static_parameter is None:
            raise ValueError(
                "this phase references static parameters; supply their values"
            )
        if static_parameter is None:
            static_parameter = []
        return np.array(list(static_parameter), dtype=np.float64)

    def refine_continuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        absolute_tolerance_continuous: float = 1e-8,
        relative_tolerance_continuous: float = 1e-8,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1e-3,
        mesh_length_max: float = 1.0,
    ) -> None:
        """hp-refinement: raise degree while it fits, else split the interval
        (reference: ``phasebase.py:1483-1578``)."""
        if self.check_continuous(
            variable,
            static_parameter,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            mesh_length_min,
        ):
            return
        mesh_new, num_point_new = self.plan_refine_continuous(
            variable,
            static_parameter,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            num_point_min,
            num_point_max,
            mesh_length_min,
            mesh_length_max,
        )
        passed = self._discontinuous_check_passed
        self.set_discretization(mesh_new, list(num_point_new))
        self._discontinuous_check_passed = passed

    def plan_refine_continuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        absolute_tolerance_continuous: float = 1e-8,
        relative_tolerance_continuous: float = 1e-8,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1e-3,
        mesh_length_max: float = 1.0,
    ):
        """Pure planning step of :meth:`refine_continuous`: returns the
        ``(mesh_new, num_point_new)`` the refinement would apply, without
        mutating the phase — the building block for batched sweeps where
        per-instance decisions must not touch shared state."""
        s = self._require_static(static_parameter)
        T_x, I_f = self._error_estimation_data_continuous(variable.data, s)
        ec = self._error_check_interval_continuous(
            T_x,
            I_f,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            mesh_length_min,
        )
        abs_err = np.abs(T_x - I_f)
        ratio = np.zeros(self.N)
        for i in range(self.N):
            if ec[i]:
                continue
            a, b = self.l_m_aug[i], self.r_m_aug[i]
            scale = 1.0 + np.abs(I_f[:, a:b]).max(axis=1, keepdims=True)
            ratio[i] = float(np.max(abs_err[:, a:b] / scale))
        return self._plan_continuous_from_stats(
            ec,
            ratio,
            relative_tolerance_continuous,
            num_point_min,
            num_point_max,
            mesh_length_min,
            mesh_length_max,
        )

    def _plan_continuous_from_stats(
        self,
        ec,
        ratio,
        relative_tolerance_continuous,
        num_point_min,
        num_point_max,
        mesh_length_min,
        mesh_length_max,
    ):
        """Mesh-construction step of :meth:`plan_refine_continuous`, fed by
        precomputed per-interval statistics (``ec``: per-interval pass
        flags; ``ratio``: per-interval max scaled residual). Batched sweeps
        can compute those on device for all instances at once and call
        this per instance with plain host scalars."""
        # Per-interval plan: each entry contributes (left borders, degrees).
        # Passing intervals are kept; failing intervals raise their degree by
        # the error-ratio log rule while it fits under num_point_max, and are
        # subdivided into minimum-degree pieces otherwise.
        borders: list[np.ndarray] = []
        degrees: list[np.ndarray] = []
        for i in range(self.N):
            left, right = float(self._mesh[i]), float(self._mesh[i + 1])
            deg = int(self._num_point[i])
            if ec[i]:
                borders.append(np.array([left]))
                degrees.append(np.array([deg]))
                continue
            bump = max(
                1,
                int(np.ceil(np.log(ratio[i] / relative_tolerance_continuous)
                            / np.log(deg))),
            )
            if deg + bump <= num_point_max:  # p-refine in place
                borders.append(np.array([left]))
                degrees.append(np.array([deg + bump]))
            else:  # h-refine: uniform split, capacity-matched piece count
                width = right - left
                pieces = max(int(np.ceil((deg + bump) / num_point_min)), 2)
                pieces = min(pieces, max(int(width / mesh_length_min), 1))
                pieces = max(pieces, int(np.ceil(width / mesh_length_max)))
                borders.append(np.linspace(left, right, pieces, endpoint=False))
                degrees.append(np.full(pieces, num_point_min))
        mesh_new = np.append(np.concatenate(borders), 1.0)
        num_point_new = np.concatenate(degrees).astype(int)
        return mesh_new, num_point_new

    def refine_discontinuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        tolerance_discontinuous: float = 1e-3,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1e-3,
        mesh_length_max: float = 1.0,
    ) -> None:
        """Bang-bang refinement: place mesh points on control switch times
        found as polynomial roots (reference: ``phasebase.py:1580-1828``)."""
        if self.check_discontinuous(
            variable, static_parameter, tolerance_discontinuous, mesh_length_min
        ):
            return
        mesh_new, num_point_new = self.plan_refine_discontinuous(
            variable,
            static_parameter,
            tolerance_discontinuous,
            num_point_min,
            num_point_max,
            mesh_length_min,
            mesh_length_max,
        )
        self.set_discretization(mesh_new, num_point_new)

    def plan_refine_discontinuous(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        tolerance_discontinuous: float = 1e-3,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1e-3,
        mesh_length_max: float = 1.0,
    ):
        """Pure planning step of :meth:`refine_discontinuous` (no phase
        mutation)."""
        from pockit_tpu_torch.base.refine_discontinuous import refine_discontinuous_mesh

        s = self._require_static(static_parameter)
        f_bb = self._error_estimation_data_discontinuous(variable.data, s)
        return refine_discontinuous_mesh(
            self,
            f_bb,
            tolerance_discontinuous,
            num_point_min,
            num_point_max,
            mesh_length_min,
            mesh_length_max,
        )

    def refine(
        self,
        variable,
        static_parameter: Optional[Iterable[float]] = None,
        absolute_tolerance_continuous: float = 1e-8,
        relative_tolerance_continuous: float = 1e-8,
        tolerance_discontinuous: float = 1e-3,
        num_point_min: int = 6,
        num_point_max: int = 12,
        mesh_length_min: float = 1e-3,
        mesh_length_max: float = 1.0,
    ) -> None:
        """Discontinuous refinement first; else continuous; at most one
        (reference: ``phasebase.py:1830-1891``)."""
        if not self._discontinuous_check_passed and not self.check_discontinuous(
            variable, static_parameter, tolerance_discontinuous, mesh_length_min
        ):
            self.refine_discontinuous(
                variable,
                static_parameter,
                tolerance_discontinuous,
                num_point_min,
                num_point_max,
                mesh_length_min,
                mesh_length_max,
            )
        elif not self.check_continuous(
            variable,
            static_parameter,
            absolute_tolerance_continuous,
            relative_tolerance_continuous,
            mesh_length_min,
        ):
            self.refine_continuous(
                variable,
                static_parameter,
                absolute_tolerance_continuous,
                relative_tolerance_continuous,
                num_point_min,
                num_point_max,
                mesh_length_min,
                mesh_length_max,
            )

    # ------------------------------------------------------------------
    # properties (reference: ``phasebase.py:1893-2238``)
    # ------------------------------------------------------------------
    @property
    def n_x(self) -> int:
        """Number of state variables."""
        return self._num_state

    @property
    def x(self) -> list[sp.Symbol]:
        """Symbols of state variables."""
        return self._symbol_state

    @property
    def n_u(self) -> int:
        """Number of control variables."""
        return self._num_control

    @property
    def u(self) -> list[sp.Symbol]:
        """Symbols of control variables."""
        return self._symbol_control

    @property
    def n(self) -> int:
        """Number of state and control variables."""
        return self._num_variable

    @property
    def n_s(self) -> int:
        """Number of static parameters."""
        return self._num_static_parameter

    @property
    def s(self) -> list[sp.Symbol]:
        """Symbols of static parameters."""
        return self._symbol_static_parameter

    @property
    def t(self) -> sp.Symbol:
        """The symbol representing time."""
        return self._symbol_time

    @property
    def F_d(self) -> list[LoweredFunc]:
        """Lowered dynamics functions."""
        return self._func_dynamics

    @property
    def n_d(self) -> int:
        return self._num_state

    @property
    def F_I(self) -> list[LoweredFunc]:
        """Lowered integrand functions."""
        return self._func_integral

    @property
    def n_I(self) -> int:
        return self._num_integral

    @property
    def I(self) -> list[sp.Symbol]:
        """Symbols of the integrals."""
        return self._symbol_integral

    @property
    def F_c(self) -> list[LoweredFunc]:
        """Lowered path-constraint functions."""
        return self._func_phase_constraint

    @property
    def n_c(self) -> int:
        return self._num_phase_constraint

    @property
    def F_b(self) -> list[LoweredFunc]:
        """Lowered bang-bang constraint functions (scaled to [0, 1])."""
        return self._func_bang_bang_control

    @property
    def n_b(self) -> int:
        return self._num_bang_bang

    @staticmethod
    def _is_pin(lb, ub) -> bool:
        """A plain-symbol bound pair with lb == ub (both numeric) pins the
        variable to a constant."""
        try:
            return lb is not None and ub is not None and float(lb) == float(ub)
        except (TypeError, ValueError):
            return False

    @property
    def pinned_variable_slots(self) -> list:
        """``[(phase-local slot index, pinned value), ...]`` for variables
        whose plain-symbol phase constraint has lb == ub.

        Such variables are substituted like FIXED boundary conditions
        (parameter treatment) instead of being boxed by an equal-bound
        pair: a zero-width box has an empty barrier interior, which in
        float32 produces infinite bound duals at initialization (the relax
        cannot be represented against the bound's magnitude) and, even
        relaxed, conditions the KKT system as O(mu/relax^2). Reference
        semantics (``phasebase.py:311-418``) treat the pair as a plain
        equality, which IPOPT in turn removes via its default
        fixed_variable_treatment=make_parameter — this is the same
        treatment, implemented through the transcription's substitution
        tables. Values are substituted at runtime via the phase's bc
        vector (appended after the boundary-condition slots), so batched
        ``bc_overrides`` can vary the pin per instance.
        """
        out = []
        for i, lb, ub in self._variable_bounds_phase:
            if self._is_pin(lb, ub):
                for idx in range(int(self.l_v[i]), int(self.r_v[i])):
                    out.append((idx, float(lb)))
        return out

    @property
    def v_lb(self) -> np.ndarray:
        """Lower bounds of the phase's optimization variables
        (reference: ``phasebase.py:603-630``). Pinned (lb == ub) variables
        are substituted as parameters instead — see pinned_variable_slots."""
        lb = np.full(self.L, -np.inf)
        for i, b, ub in self._variable_bounds_phase:
            if self._is_pin(b, ub):
                continue
            lb[self.l_v[i] : self.r_v[i]] = np.maximum(lb[self.l_v[i] : self.r_v[i]], b)
        for b, _ in self._time_bounds_phase:
            lb[-2] = np.maximum(lb[-2], b)
            lb[-1] = np.maximum(lb[-1], b)
        return lb

    @property
    def v_ub(self) -> np.ndarray:
        """Upper bounds of the phase's optimization variables."""
        ub = np.full(self.L, np.inf)
        for i, b_lo, b in self._variable_bounds_phase:
            if self._is_pin(b_lo, b):
                continue
            ub[self.l_v[i] : self.r_v[i]] = np.minimum(ub[self.l_v[i] : self.r_v[i]], b)
        for _, b in self._time_bounds_phase:
            ub[-2] = np.minimum(ub[-2], b)
            ub[-1] = np.minimum(ub[-1], b)
        return ub

    @property
    def c_lb(self) -> np.ndarray:
        return self._lower_bound_phase_constraint

    @property
    def c_ub(self) -> np.ndarray:
        return self._upper_bound_phase_constraint

    @property
    def s_b(self) -> list[tuple[int, float, float]]:
        """Static-parameter bounds collected from plain-symbol constraints."""
        return self._static_parameter_bounds_phase

    @property
    def bc_0(self):
        return self._initial_value

    @property
    def bc_f(self):
        return self._terminal_value

    @property
    def t_0(self):
        return self._initial_time

    @property
    def t_f(self):
        return self._terminal_time

    @property
    def N(self) -> int:
        """Number of subintervals."""
        return self._num_interval

    @property
    def ok(self) -> bool:
        """Whether the phase is fully configured."""
        return (
            self._dynamics_set
            and self._boundary_condition_set
            and self._discretization_set
        )

    @property
    def d(self) -> Discretization:
        """The static discretization data of this phase."""
        return self._object_discretization

    # layout delegations
    @property
    def l_v(self):
        return self.d.l_v

    @property
    def r_v(self):
        return self.d.r_v

    @property
    def t_m(self):
        return self.d.t_m

    @property
    def w_m(self):
        return self.d.w_m

    @property
    def l_m(self):
        return self.d.l_m

    @property
    def r_m(self):
        return self.d.r_m

    @property
    def L_m(self):
        return self.d.L_m

    @property
    def l_m_aug(self):
        return self.d.l_m_aug

    @property
    def r_m_aug(self):
        return self.d.r_m_aug

    @property
    def L_m_aug(self):
        return self.d.L_m_aug

    @property
    def t_x(self):
        return self.d.t_x

    @property
    def t_u(self):
        return self.d.t_u

    @property
    def l_x(self):
        return self.d.l_x

    @property
    def r_x(self):
        return self.d.r_x

    @property
    def l_u(self):
        return self.d.l_u

    @property
    def r_u(self):
        return self.d.r_u

    @property
    def l_d(self):
        return self.d.l_d

    @property
    def r_d(self):
        return self.d.r_d

    @property
    def L_x(self) -> int:
        """Length of all state variables."""
        return int(self.r_v[self.n_x - 1]) if self.n_x else 0

    @property
    def L_xu(self) -> int:
        """Length of all state and control variables."""
        return self.d.L_xu

    @property
    def L(self) -> int:
        """Length of the phase vector (variables + t_0, t_f)."""
        return self.d.L
