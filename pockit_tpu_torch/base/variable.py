"""Solution/guess container for a discretized phase.

Mirrors the reference ``VariableBase`` (``pockit/base/
variablebase.py:65-460``): a flat host-side vector with named views, dense
interpolation matrices for plotting/export, mesh adaptation, and guess
constructors. Interpolation matrices are dense numpy (host path — device code
never touches this class).
"""

from __future__ import annotations

from typing import Iterable, Type

import numpy as np

from pockit_tpu_torch.base.bc import BcType
from pockit_tpu_torch.numerics import V_interpolation, D_interpolation
from pockit_tpu_torch.numerics.layout import lr_c


class BatchIndexArray:
    """Index a batch of variable slices out of a flat vector."""

    def __init__(self, data, l_index, r_index):
        if not len(l_index) == len(r_index):
            raise ValueError(
                "l_index and r_index are parallel arrays; their lengths differ"
            )
        self._data = data
        self._l_index = l_index
        self._r_index = r_index
        self._n = len(l_index)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._data[self._l_index[i] : self._r_index[i]]

    def __setitem__(self, i: int, value) -> None:
        self._data[self._l_index[i] : self._r_index[i]] = value

    def __len__(self) -> int:
        return self._n


class VariableBase:
    """Optimization variable for one discretized phase."""

    def __init__(self, phase, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=np.float64)
        if len(data) != phase.L:
            raise ValueError(f"data must have length {phase.L}, got {len(data)}")
        self._data = data
        self._l_v = phase.l_v
        self._r_v = phase.r_v
        self._n_x = phase.n_x
        self._n_u = phase.n_u
        self._n = phase.n
        self._array_state = BatchIndexArray(
            data, self._l_v[: self._n_x], self._r_v[: self._n_x]
        )
        self._array_control = BatchIndexArray(
            data, self._l_v[self._n_x :], self._r_v[self._n_x :]
        )
        self._mesh = phase._mesh
        self._num_point = phase._num_point
        self._N = phase.N
        self._t_x = phase.t_x
        self._t_u = phase.t_u
        self._l_x = phase.l_x
        self._r_x = phase.r_x
        self._l_u = phase.l_u
        self._r_u = phase.r_u

    # -- time partition helpers --------------------------------------------
    # Semantics match the reference (``variablebase.py:136-172``): output
    # times within tolerance of an interior mesh edge sample the interval to
    # the LEFT of that edge, except that a *repeated* border time crosses to
    # the right interval (so discontinuous controls can be read from both
    # sides of a switch). The implementation here is vectorized: one
    # searchsorted pass plus boolean masks, no stateful walk.

    @staticmethod
    def _near(a, b) -> np.ndarray:
        """Elementwise closeness with a 1e-8 absolute + relative band."""
        return np.abs(np.asarray(a) - np.asarray(b)) <= 1e-8 * (
            1.0 + np.abs(np.asarray(b))
        )

    def _interval_counts(self, tau: np.ndarray) -> np.ndarray:
        """How many (ascending, scaled) output times land in each
        subinterval, honoring the border rules above. Because ``tau`` is
        ascending and the assignment is monotone, splitting ``tau`` by these
        counts reproduces the partition."""
        edges = np.asarray(self._mesh, dtype=np.float64)
        N = self._N
        k = np.clip(np.searchsorted(edges, tau, side="right") - 1, 0, N - 1)
        # tolerance-snap: close to the left edge of the located interval
        # means the point sits ON an interior border and belongs left
        on_left_edge = (k > 0) & self._near(tau, edges[k])
        on_right_edge = (k + 1 < N) & self._near(tau, edges[np.minimum(k + 1, N)])
        base = np.where(on_left_edge, k - 1, k)
        at_border = on_left_edge | on_right_edge
        # a duplicate of the previous time at a border crosses rightward
        dup = np.zeros_like(at_border)
        if tau.size > 1:
            dup[1:] = self._near(tau[1:], tau[:-1])
        assign = np.where(at_border & dup & (base + 1 < N), base + 1, base)
        return np.bincount(assign, minlength=N)

    def _guard_t(self, t: np.ndarray) -> np.ndarray:
        """Validate output times (ascending, inside [t_0, t_f] up to a 1e-8
        band) and return them scaled to [0, 1]."""
        t = np.array(t, dtype=np.float64)
        if t.size > 1:
            drop = t[:-1] - t[1:]
            if np.any((drop > 0) & ~np.isclose(t[:-1], t[1:])):
                raise ValueError("output times must be in ascending order")
        lo, hi = self.t_0, self.t_f
        if t[0] < lo - 1e-8 or t[-1] > hi + 1e-8:
            raise ValueError(
                f"output times must lie within [{lo}, {hi}] "
                f"(got [{t[0]}, {t[-1]}])"
            )
        t[0] = max(t[0], lo)
        t[-1] = min(t[-1], hi)
        return (t - lo) / (hi - lo)

    # -- dense assembly (shared vs non-shared borders) -------------------
    @staticmethod
    def _assemble_c(num_point, blocks) -> np.ndarray:
        """Stack per-interval interpolation blocks over a shared-border
        variable grid."""
        l_c, r_c = lr_c(num_point)
        L_col = int(r_c[-1])
        rows = sum(b.shape[0] for b in blocks)
        M = np.zeros((rows, L_col))
        r0 = 0
        for i, b in enumerate(blocks):
            if not b.shape[0]:
                continue
            M[r0 : r0 + b.shape[0], l_c[i] : l_c[i] + b.shape[1]] = b
            r0 += b.shape[0]
        return M

    @staticmethod
    def _assemble_nc(blocks) -> np.ndarray:
        """Block-diagonal stack over a non-shared variable grid."""
        rows = sum(b.shape[0] for b in blocks)
        cols = sum(b.shape[1] for b in blocks)
        M = np.zeros((rows, cols))
        r0 = c0 = 0
        for b in blocks:
            M[r0 : r0 + b.shape[0], c0 : c0 + b.shape[1]] = b
            r0 += b.shape[0]
            c0 += b.shape[1]
        return M

    def _assemble_x(self, blocks) -> np.ndarray:
        raise NotImplementedError

    def _assemble_u(self, blocks) -> np.ndarray:
        raise NotImplementedError

    def _matrix(self, t, nodes, l_idx, r_idx, interpolation, assemble):
        tau = self._guard_t(t)
        counts = self._interval_counts(tau)
        groups = np.split(tau, np.cumsum(counts)[:-1])
        blocks = [
            interpolation(nodes[l_idx[i] : r_idx[i]], g) for i, g in enumerate(groups)
        ]
        return assemble(blocks)

    def V_x(self, t) -> np.ndarray:
        """Value interpolation matrix for states at output times ``t``."""
        return self._matrix(
            t, self._t_x, self._l_x, self._r_x, V_interpolation, self._assemble_x
        )

    def V_u(self, t) -> np.ndarray:
        """Value interpolation matrix for controls at output times ``t``."""
        return self._matrix(
            t, self._t_u, self._l_u, self._r_u, V_interpolation, self._assemble_u
        )

    def D_x(self, t) -> np.ndarray:
        """Derivative interpolation matrix for states at output times ``t``.

        Derivatives are taken with respect to the phase-scaled time
        ``τ = (t - t_0) / (t_f - t_0)``, matching the reference convention
        (``variablebase.py:260-284``); divide by ``t_f - t_0`` for
        physical-time derivatives.
        """
        return self._matrix(
            t, self._t_x, self._l_x, self._r_x, D_interpolation, self._assemble_x
        )

    def D_u(self, t) -> np.ndarray:
        """Derivative interpolation matrix for controls at output times ``t``
        (with respect to phase-scaled time, see :meth:`D_x`)."""
        return self._matrix(
            t, self._t_u, self._l_u, self._r_u, D_interpolation, self._assemble_u
        )

    # -- accessors -------------------------------------------------------
    @property
    def x(self) -> BatchIndexArray:
        """State variables, indexable by state number."""
        return self._array_state

    @property
    def u(self) -> BatchIndexArray:
        """Control variables, indexable by control number."""
        return self._array_control

    @property
    def t_0(self) -> float:
        return self._data[-2]

    @t_0.setter
    def t_0(self, value: float) -> None:
        self._data[-2] = value

    @property
    def t_f(self) -> float:
        return self._data[-1]

    @t_f.setter
    def t_f(self, value: float) -> None:
        self._data[-1] = value

    @property
    def data(self) -> np.ndarray:
        """The flat phase vector (pass to the solver)."""
        return self._data

    @property
    def t_x(self) -> np.ndarray:
        """Physical time at the state interpolation nodes."""
        return self._t_x * (self.t_f - self.t_0) + self.t_0

    @property
    def t_u(self) -> np.ndarray:
        """Physical time at the control interpolation nodes."""
        return self._t_u * (self.t_f - self.t_0) + self.t_0

    def adapt_matrices(self, phase):
        """The (V_x, V_u) interpolation matrices :meth:`adapt` applies.
        They depend only on the source/target mesh layouts (normalized
        node positions), not on this variable's values or time span — so
        batched sweeps cache them per (old, new) mesh-signature pair and
        re-use them across every instance in a bucket."""
        span = self.t_f - self.t_0
        return (
            self.V_x(phase.t_x * span + self.t_0),
            self.V_u(phase.t_u * span + self.t_0),
        )

    def adapt(self, phase, matrices=None):
        """Re-interpolate this solution onto a phase with a different mesh
        (warm start for the refine loop; same role as the reference's
        ``variablebase.py:360-385``).

        One interpolation matrix per variable *kind* (state grid / control
        grid) is built against the new phase's node times (or taken from
        ``matrices``, see :meth:`adapt_matrices`), then applied to every
        variable of that kind."""
        V_x_m, V_u_m = (
            matrices if matrices is not None else self.adapt_matrices(phase)
        )
        data_new = np.empty(phase.L)
        for kind, n_var, offset, V in (
            ("x", phase.n_x, 0, V_x_m),
            ("u", phase.n_u, phase.n_x, V_u_m),
        ):
            src = self.x if kind == "x" else self.u
            for i in range(n_var):
                lo, hi = phase.l_v[offset + i], phase.r_v[offset + i]
                data_new[lo:hi] = V @ src[i]
        data_new[-2:] = (self.t_0, self.t_f)
        return type(self)(phase, data_new)


def _guess_time_span(phase, fill: float) -> tuple:
    """Initial ``(t_0, t_f)`` for a guess: configured values where FIXED,
    otherwise the fill value pushed half a unit outward so the initial
    ``t_f - t_0`` span is never degenerate (reference convention,
    ``variablebase.py:388-460``)."""
    t0 = phase.t_0 if phase.info_t_0.t == BcType.FIXED else fill - 0.5
    tf = phase.t_f if phase.info_t_f.t == BcType.FIXED else fill + 0.5
    return t0, tf


def _fixed_endpoint_values(phase, i: int) -> tuple:
    """``(bc_0 or None, bc_f or None)`` for state ``i`` — None when not
    FIXED."""
    b0 = phase.bc_0[i] if phase.info_bc_0[i].t == BcType.FIXED else None
    bf = phase.bc_f[i] if phase.info_bc_f[i].t == BcType.FIXED else None
    return b0, bf


def _make_guess(Variable, phase, fill: float, interp: bool) -> "VariableBase":
    """Shared core of the guess constructors.

    ``interp=False``: constant ``fill`` everywhere, with FIXED endpoint
    values written onto the first/last state samples only.
    ``interp=True``: each state profile is the line through its FIXED
    endpoints (constant when only one end is FIXED, ``fill`` when neither).
    """
    if not phase.ok:
        raise ValueError(
            "phase setup is incomplete: set dynamics, boundary conditions "
            "and the discretization first"
        )
    v = Variable(phase, np.full(phase.L, float(fill)))
    for i in range(phase.n_x):
        b0, bf = _fixed_endpoint_values(phase, i)
        if interp:
            if b0 is not None and bf is not None:
                v.x[i] = b0 + (bf - b0) * v._t_x
            elif b0 is not None:
                v.x[i] = b0
            elif bf is not None:
                v.x[i] = bf
        else:
            if b0 is not None:
                v.x[i][0] = b0
            if bf is not None:
                v.x[i][-1] = bf
    v.t_0, v.t_f = _guess_time_span(phase, float(fill))
    return v


def constant_guess_base(
    Variable: Type[VariableBase], phase, value: float = 1.0
) -> VariableBase:
    """Constant guess honoring FIXED boundary conditions."""
    return _make_guess(Variable, phase, value, interp=False)


def linear_guess_base(
    Variable: Type[VariableBase], phase, default: float = 1.0
) -> VariableBase:
    """Per-state linear guess between FIXED boundary conditions."""
    return _make_guess(Variable, phase, default, interp=True)
