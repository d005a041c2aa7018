"""Static discretization data for one phase: dense block-structured matrices.

The port's own copy of ``pockit_tpu/base/discretization.py`` (plain numpy;
held against it by ``tests/test_torch_numerics.py``). Where upstream
pockit assembles scipy CSR matrices and per-entry COO index lists
(``pockit/lobatto/discretization.py:169-227``,
``pockit/radau/discretization.py:199-257``), the operators are *dense*
numpy arrays: collocation operators are block diagonal with tiny blocks
(n ≈ 6..12), so the dense form is small.

Index semantics (shared vs. non-shared borders, Radau's extra terminal state
point) exactly mirror the reference:

- LGL (`lobatto`): states and controls share interval borders, both of
  length ``sum(n_i - 1) + 1``; the middle stage *is* the variable grid
  (``lobatto/discretization.py:414-441``).
- LGR (`radau`): controls hold ``n_i`` points per interval (non-shared, no
  terminal point), states get one extra terminal point at ``t = 1``
  (``radau/discretization.py:44-67, 488-521``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from pockit_tpu_torch.numerics import (
    integral_matrix,
    lagrange_values,
    polynomial_coefficients,
    xw_lgl,
    xw_lgr,
)
from pockit_tpu_torch.numerics.layout import lr_c, lr_nc


def _scaled_nodes(
    mesh: np.ndarray, num_point: np.ndarray, xw, shared: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Join per-interval nodes/weights scaled into their mesh cells.

    Returns ``(t, w, l, r)`` where shared-border weights accumulate
    (LGL) or are simply assigned (LGR)."""
    l, r = (lr_c if shared else lr_nc)(num_point)
    L = int(r[-1])
    t = np.zeros(L)
    w = np.zeros(L)
    width = np.diff(mesh)
    mid = (mesh[1:] + mesh[:-1]) / 2
    for li, ri, n, d, m in zip(l, r, num_point, width, mid):
        x_, w_ = xw(int(n))
        t[li:ri] = x_ * d / 2 + m
        w[li:ri] += w_ * d / 2
    return t, w, l, r


def _place_blocks(shape, blocks, row_l, col_l) -> np.ndarray:
    """Assemble dense matrix from per-interval blocks at given offsets.
    Overlapping entries are summed (shared borders)."""
    M = np.zeros(shape)
    for B, rl, cl in zip(blocks, row_l, col_l):
        h, w = B.shape
        M[rl : rl + h, cl : cl + w] += B
    return M


@functools.lru_cache(maxsize=None)
def _translation_block(family: str, n: int) -> np.ndarray:
    """Per-interval translation matrix ``[I | -1]`` eliminating the
    integration constant at the right end (reference ``T_lgl``/``T_lgr``)."""
    rows = n - 1 if family == "lobatto" else n
    return np.hstack([np.eye(rows), np.full((rows, 1), -1.0)])


@functools.lru_cache(maxsize=None)
def _integration_block(family: str, n: int) -> np.ndarray:
    """Per-interval integration matrix on the reference cell ``[-1, 1]``
    (reference ``I_lgl``/``I_lgr``): rows are the translation targets,
    columns the middle-stage nodes; integrates from +1 backwards."""
    if family == "lobatto":
        x, _ = xw_lgl(n)
        return integral_matrix(x, x[:-1])
    x, _ = xw_lgr(n)
    return integral_matrix(x, x)


@dataclass(frozen=True)
class Discretization:
    """All static (mesh-dependent) data of one discretized phase."""

    family: str
    mesh: np.ndarray
    num_point: np.ndarray
    n_x: int
    n_u: int

    # variable grid
    L_x_var: int = field(init=False)  # points per state variable
    L_u_var: int = field(init=False)  # points per control variable
    l_v: np.ndarray = field(init=False)
    r_v: np.ndarray = field(init=False)
    t_x: np.ndarray = field(init=False)
    t_u: np.ndarray = field(init=False)
    l_x: np.ndarray = field(init=False)
    r_x: np.ndarray = field(init=False)
    l_u: np.ndarray = field(init=False)
    r_u: np.ndarray = field(init=False)

    # middle stage
    t_m: np.ndarray = field(init=False)
    w_m: np.ndarray = field(init=False)
    l_m: np.ndarray = field(init=False)
    r_m: np.ndarray = field(init=False)
    L_m: int = field(init=False)
    mstage_has_back: bool = field(init=False)

    # dynamic constraints
    L_d: int = field(init=False)  # rows per state variable
    l_d: np.ndarray = field(init=False)
    r_d: np.ndarray = field(init=False)
    T_v: np.ndarray = field(init=False)  # (L_d, L_x_var)
    I_m: np.ndarray = field(init=False)  # (L_d, L_m)

    # augmented grid for error estimation
    t_m_aug: np.ndarray = field(init=False)
    l_m_aug: np.ndarray = field(init=False)
    r_m_aug: np.ndarray = field(init=False)
    L_m_aug: int = field(init=False)
    w_itv: tuple = field(init=False)  # per-interval (non-aug) weights
    V_x_aug: np.ndarray = field(init=False)  # (rows_aug_x, L_x_var)
    V_u_aug: np.ndarray = field(init=False)  # (rows_aug_u, L_u_var)
    T_x_aug_v: np.ndarray = field(init=False)  # per-variable aug translation
    I_m_aug: np.ndarray = field(init=False)  # aug integration matrix

    def __post_init__(self):
        family = self.family
        if family not in ("lobatto", "radau"):
            raise ValueError(f"unknown scheme family: {family}")
        mesh = np.asarray(self.mesh, dtype=np.float64)
        num_point = np.asarray(self.num_point, dtype=np.int64)
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "num_point", num_point)
        n_x, n_u = self.n_x, self.n_u
        width = np.diff(mesh)

        set_ = lambda k, v: object.__setattr__(self, k, v)

        if family == "lobatto":
            xw = xw_lgl
            t_m, w_m, l_m, r_m = _scaled_nodes(mesh, num_point, xw, shared=True)
            L_m = int(r_m[-1])
            L_x_var = L_u_var = L_m
            set_("t_x", t_m), set_("t_u", t_m)
            set_("l_x", l_m), set_("r_x", r_m)
            set_("l_u", l_m), set_("r_u", r_m)
            set_("mstage_has_back", True)

            l_dr, r_dr = lr_nc(num_point - 1)  # constraint rows
            L_d = int(r_dr[-1])
            col_l = l_m  # state cols, shared
            T_blocks = [_translation_block(family, int(n)) for n in num_point]
            I_blocks = [
                _integration_block(family, int(n)) * d / 2
                for n, d in zip(num_point, width)
            ]
            set_("T_v", _place_blocks((L_d, L_x_var), T_blocks, l_dr, col_l))
            set_("I_m", _place_blocks((L_d, L_m), I_blocks, l_dr, col_l))

            # augmented grid
            t_m_aug, _, l_m_aug, r_m_aug = _scaled_nodes(
                mesh, num_point + 1, xw, shared=True
            )
            L_m_aug = int(r_m_aug[-1])
            # V_s_aug: variable values -> aug nodes (shared rows written once)
            V_blocks, V_rl = [], []
            rl_aug, _ = lr_c(num_point + 1)
            for i, n in enumerate(num_point):
                x_, _ = xw(int(n))
                x_aug, _ = xw(int(n) + 1)
                V = lagrange_values(x_aug, x_)  # (n+1, n)
                if i == 0:
                    V_blocks.append(V)
                    V_rl.append(rl_aug[i])
                else:
                    V_blocks.append(V[1:])
                    V_rl.append(rl_aug[i] + 1)
            V_s_aug = _place_blocks((L_m_aug, L_x_var), V_blocks, V_rl, col_l)
            set_("V_x_aug", V_s_aug)
            set_("V_u_aug", V_s_aug)

            # T_x_aug: (sum n_i) rows per variable
            rl_T, r_T = lr_nc(num_point)
            T_aug_blocks = []
            for n in num_point:
                x_, _ = xw(int(n))
                x_aug, _ = xw(int(n) + 1)
                val = lagrange_values(x_aug, x_)  # (n+1, n)
                T_aug_blocks.append(val[:-1] - val[-1])  # (n, n)
            set_(
                "T_x_aug_v",
                _place_blocks((int(r_T[-1]), L_x_var), T_aug_blocks, rl_T, col_l),
            )
            I_aug_blocks = [
                _integration_block(family, int(n) + 1) * d / 2
                for n, d in zip(num_point, width)
            ]
            set_(
                "I_m_aug",
                _place_blocks((int(r_T[-1]), L_m_aug), I_aug_blocks, rl_T, l_m_aug),
            )
            set_("w_itv", tuple(xw(int(n))[1] for n in num_point))

        else:  # radau
            xw = xw_lgr
            t_m, w_m, l_m, r_m = _scaled_nodes(mesh, num_point, xw, shared=False)
            L_m = int(r_m[-1])
            L_u_var = L_m
            L_x_var = L_m + 1
            set_("t_x", np.concatenate([t_m, [1.0]]))
            set_("t_u", t_m)
            l_xc, r_xc = lr_c(num_point + 1)
            set_("l_x", l_xc), set_("r_x", r_xc)
            set_("l_u", l_m), set_("r_u", r_m)
            set_("mstage_has_back", False)

            l_dr, r_dr = lr_nc(num_point)
            L_d = int(r_dr[-1])
            T_blocks = [_translation_block(family, int(n)) for n in num_point]
            I_blocks = [
                _integration_block(family, int(n)) * d / 2
                for n, d in zip(num_point, width)
            ]
            set_("T_v", _place_blocks((L_d, L_x_var), T_blocks, l_dr, l_xc))
            set_("I_m", _place_blocks((L_d, L_m), I_blocks, l_dr, l_m))

            t_m_aug, _, l_m_aug, r_m_aug = _scaled_nodes(
                mesh, num_point + 1, xw, shared=False
            )
            L_m_aug = int(r_m_aug[-1])

            # states: nodes ∪ {1} per interval mapped to aug nodes
            Vx_blocks, Tx_blocks, Vu_blocks = [], [], []
            for n, d in zip(num_point, width):
                x_, _ = xw(int(n))
                x_1 = np.concatenate([x_, [1.0]])
                x_aug, _ = xw(int(n) + 1)
                Vx_blocks.append(lagrange_values(x_aug, x_1))  # (n+1, n+1)
                x_aug_1 = np.concatenate([x_aug, [1.0]])
                val = lagrange_values(x_aug_1, x_1)  # (n+2, n+1)
                Tx_blocks.append(val[:-1] - val[-1])  # (n+1, n+1)
                Vu_blocks.append(lagrange_values(x_aug, x_))  # (n+1, n)
            rows_aug = int(r_m_aug[-1])
            set_(
                "V_x_aug",
                _place_blocks((rows_aug, L_x_var), Vx_blocks, l_m_aug, l_xc),
            )
            set_(
                "T_x_aug_v",
                _place_blocks((rows_aug, L_x_var), Tx_blocks, l_m_aug, l_xc),
            )
            set_(
                "V_u_aug",
                _place_blocks((rows_aug, L_u_var), Vu_blocks, l_m_aug, l_m),
            )
            I_aug_blocks = [
                _integration_block(family, int(n) + 1) * d / 2
                for n, d in zip(num_point, width)
            ]
            set_(
                "I_m_aug",
                _place_blocks((rows_aug, L_m_aug), I_aug_blocks, l_m_aug, l_m_aug),
            )
            set_("w_itv", tuple(xw(int(n))[1] for n in num_point))

        # variable layout: states first, then controls, half-open ranges
        lengths = [L_x_var] * n_x + [L_u_var] * n_u
        l_v = np.concatenate(([0], np.cumsum(lengths[:-1]))).astype(np.int64)
        r_v = np.cumsum(lengths).astype(np.int64)
        set_("l_v", l_v), set_("r_v", r_v)
        set_("L_x_var", L_x_var), set_("L_u_var", L_u_var)
        set_("t_m", t_m), set_("w_m", w_m)
        set_("l_m", l_m), set_("r_m", r_m), set_("L_m", L_m)
        set_("L_d", L_d)
        l_d, r_d = lr_nc(np.full(n_x, L_d, dtype=np.int64))
        set_("l_d", l_d), set_("r_d", r_d)
        set_("t_m_aug", t_m_aug)
        set_("l_m_aug", l_m_aug), set_("r_m_aug", r_m_aug)
        set_("L_m_aug", L_m_aug)

    # ------------------------------------------------------------------
    @property
    def N(self) -> int:
        """Number of subintervals."""
        return len(self.num_point)

    @property
    def L_xu(self) -> int:
        """Total length of all state and control variables."""
        return int(self.r_v[-1]) if len(self.r_v) else 0

    @property
    def L(self) -> int:
        """Phase vector length: all variables plus ``t_0``, ``t_f``."""
        return self.L_xu + 2

    @property
    def L_x(self) -> int:
        """Total length of all state variables."""
        return self.n_x * self.L_x_var

    def state_to_mid(self, x_var):
        """Middle-stage values of one state variable (LGL: identity; LGR:
        drop the terminal point — reference ``radau/discretization.py:143-166``)."""
        if self.family == "lobatto":
            return x_var
        return x_var[..., :-1]

    def P(self, n: int) -> np.ndarray:
        """Monomial-coefficient matrix of the interpolation basis for ``n``
        points of this family (for bang-bang root finding)."""
        x, _ = (xw_lgl if self.family == "lobatto" else xw_lgr)(n)
        return polynomial_coefficients(x)
