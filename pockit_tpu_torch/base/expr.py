"""SymPy -> PyTorch lowering.

User expressions are lowered once to torch callables; gradients and
Hessians come from ``torch.func`` at the transcription level.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import sympy as sp
import torch
from sympy.printing.pytorch import TorchPrinter

# Numeric coefficients outside this range are folded into an adjacent
# exponential before lambdification (see _fold_extreme_exp_coeffs).
# float32 max is ~3.4e38; 1e30 leaves headroom for downstream products.
_F32_SAFE_MAG = 1e30


def host_constant(data, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype, device)`` made outside every
    ``torch.func`` transform level: a constant made inside ``grad`` or
    ``jvp`` would otherwise be wrapped for that level, which neither a cache
    past the call nor a traced program (``make_fx``, ``torch.export``) can
    hold. Its value and every derivative through it are the same."""
    with torch._C._DisableFuncTorch():
        return torch.as_tensor(data, dtype=dtype, device=device)


def is_cacheable(t: torch.Tensor) -> bool:
    """Whether a constant ``t`` made by :func:`host_constant` may be cached
    past the call that made it: not while ``torch.export`` traces, where it
    is a fake or functional tensor subclass that a later call would feed
    back into a trace as a constant."""
    return type(t) is torch.Tensor and not torch._C._functorch.is_functorch_wrapped_tensor(t)


class _exp_folded(sp.Function):
    """Opaque stand-in for ``exp`` with NO auto-evaluation rules.

    ``sp.exp`` eagerly splits numeric terms out of its argument
    (``exp(x + 505.7) -> 4.3e219 * exp(x)``), which re-creates the exact
    overflow _fold_extreme_exp_coeffs removes as soon as ``replace``
    rebuilds the parent nodes. This subclass carries no such rule, so the
    folded form survives symbolic rebuilding; :class:`_Printer` prints it as
    ``torch.exp``.
    """

    nargs = 1


class _Printer(TorchPrinter):
    """sympy's torch printer, which refuses unknown functions, taught to
    print the opaque :class:`_exp_folded` as ``exp``."""

    def _print__exp_folded(self, expr):
        return f"{self._module_format('torch.exp')}({self._print(expr.args[0])})"


def _fold_extreme_exp_coeffs(expr):
    """Rewrite ``c*exp(y) -> sign(c)*exp(y + ln|c|)`` for |c| outside the
    float32-safe magnitude range.

    SymPy auto-distributes float coefficients and splits constant terms out
    of exponentials: ``310*exp(-500*(h-1))`` becomes
    ``4.35e219*exp(-500*h)``, whose coefficient is exact in float64 but
    overflows to inf in float32, poisoning every dynamics evaluation (the
    3-phase Goddard gate dies at iteration 0 on chip). Folding the
    coefficient back into the exponent is exact up to one float64 rounding
    of the log and keeps every intermediate in range. The folded result
    uses ``_exp_folded`` so SymPy cannot re-split it; it is built for
    lambdification only, never re-entered into symbolic rewriting.
    """

    def _is_extreme(coeff) -> bool:
        if not coeff.is_Number or not coeff.is_finite or coeff == 0:
            return False
        # float() may overflow to inf for coefficients beyond float64
        # range (e.g. exp-splitting of steep exponentials); those are
        # exactly the coefficients that MUST be folded, so inf counts as
        # extreme — the log below is taken at sympy precision, not via
        # the overflowed float
        c = abs(float(coeff))
        return c > _F32_SAFE_MAG or c < 1.0 / _F32_SAFE_MAG

    def _fold(m):
        coeff, rest = m.as_coeff_Mul()
        if not _is_extreme(coeff):
            return m
        factors = sp.Mul.make_args(rest)
        exps = [f for f in factors if isinstance(f, sp.exp)]
        if not exps:
            return m  # genuinely out-of-range constant: leave untouched
        e = exps[0]
        others = [f for f in factors if f is not e]
        # log at sympy/mpmath precision: float64 overflows (|c| > ~1.8e308)
        # would give math.log(inf) = inf and fold to exp(arg + oo) — wrong
        # everywhere even where the true value is representable
        logc_sym = sp.log(abs(coeff)).evalf()
        if not logc_sym.is_finite:
            return m  # zero/degenerate coefficient: leave untouched
        logc = sp.Float(logc_sym)
        folded = _exp_folded(e.args[0] + logc)
        sign = [] if coeff > 0 else [sp.Integer(-1)]
        return sp.Mul(*sign, *others, folded)

    return expr.replace(lambda node: node.is_Mul, _fold)


class LoweredFunc:
    """A sympy expression lowered to a broadcasting torch callable.

    Calling convention: ``fn(values)`` with one tensor (or numpy array, or
    scalar) per symbol in ``symbols``; the result is a tensor broadcast to
    the common input shape, which makes constant expressions (lambdify
    returns a bare Python scalar) safe. Non-tensor values take the dtype
    and device of the first tensor among ``values``; when there is none
    (host callers passing numpy), numpy's own dtypes are kept.
    """

    def __init__(self, expr, symbols: Sequence[sp.Symbol]):
        self.expr = sp.sympify(expr)
        self.symbols = list(symbols)
        free = self.expr.free_symbols
        unknown = free - set(self.symbols)
        if unknown:
            raise ValueError(
                f"expression {self.expr} contains unknown symbols {unknown}"
            )
        # fold float32-overflowing exp coefficients for codegen only;
        # self.expr keeps the canonical evaluated form for symbolic use
        folded = _fold_extreme_exp_coeffs(self.expr)
        # non-integer constants become extra arguments, passed as 0-d
        # tensors of the inputs' dtype: a Python float inside a
        # torch.func.jacfwd(grad(...)) trace promotes float32 tangents to
        # float64 (the wrapped-number rule is lost under forward-mode AD)
        consts = sorted(
            (a for a in folded.atoms(sp.Number, sp.NumberSymbol) if not a.is_Integer),
            key=sp.srepr,
        )
        dummies = [sp.Dummy(f"c{k}") for k in range(len(consts))]
        self._consts = [float(c) for c in consts]
        self._const_cache = {}
        self._fn = sp.lambdify(
            self.symbols + dummies,
            folded.xreplace(dict(zip(consts, dummies))),
            modules="torch",
            printer=_Printer(
                {"fully_qualified_modules": False, "inline": True, "allow_unknown_functions": True}
            ),
        )

    def __call__(self, values):
        values = list(values)
        if len(values) != len(self.symbols):
            raise ValueError(
                f"expected {len(self.symbols)} arguments, got {len(values)}"
            )
        ref = next((v for v in values if isinstance(v, torch.Tensor)), None)
        if ref is None:
            values = [torch.as_tensor(np.asarray(v)) for v in values]
            dtype = next(
                (v.dtype for v in values if v.is_floating_point()), torch.float64
            )
            device = torch.device("cpu")
        else:
            dtype, device = ref.dtype, ref.device
            values = [
                v
                if isinstance(v, torch.Tensor)
                else host_constant(v, dtype=dtype, device=device)
                for v in values
            ]
        key = (dtype, device)
        consts = self._const_cache.get(key)
        if consts is None:
            consts = [host_constant(c, dtype=dtype, device=device) for c in self._consts]
            if all(map(is_cacheable, consts)):
                self._const_cache[key] = consts
        out = self._fn(*values, *consts)
        shape = torch.broadcast_shapes(*[v.shape for v in values]) if values else ()
        if not isinstance(out, torch.Tensor):
            out = host_constant(out, dtype=dtype, device=device)
        if out.shape != shape:
            out = torch.broadcast_to(out, shape)
        return out

    def __repr__(self):
        return f"LoweredFunc({self.expr})"
