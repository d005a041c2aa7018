"""Drop-in compatibility shim for scripts written against pockit's IPOPT
adapter (``from pockit.optimizer import ipopt``).

The port of ``pockit_tpu/optimizer/ipopt.py``: solves with the native
interior-point method; ``optimizer_options`` may be a plain dict of IPOPT
option names (the common ones are translated, the rest are ignored with a
warning) or an :class:`IPOptions` instance. Runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions

_OPTION_MAP = {
    "tol": "tol",
    "max_iter": "max_iter",
    "mu_init": "mu_init",
    "bound_relax_factor": "bound_relax",
    "mu_strategy": "mu_strategy",  # translated below: 'adaptive' -> 'mehrotra'
}
# IPOPT's mu_strategy=adaptive defaults to a Mehrotra-type probing oracle
# (its mu_oracle option); the native equivalent is 'mehrotra'. The native
# 'adaptive' value (the LOQO centrality rule) is not ported.
_VALUE_MAP = {"mu_strategy": {"adaptive": "mehrotra"}}
_IGNORED = {
    "print_level",
    "sb",
    "linear_solver",
    "hessian_approximation",
    "output_file",
    "print_timing_statistics",
}


def _translate(
    options: Optional[Union[dict, IPOptions]], dtype=None
) -> Optional[IPOptions]:
    """IPOPT option names to an :class:`IPOptions` over the defaults of
    ``dtype`` (``ipm.default_options``)."""
    if options is None or isinstance(options, IPOptions):
        return options
    base = ipm.default_options(dtype)
    kwargs = {}
    for k, v in options.items():
        if k in _OPTION_MAP:
            kwargs[_OPTION_MAP[k]] = _VALUE_MAP.get(k, {}).get(v, v)
        elif k not in _IGNORED:
            warnings.warn(f"IPOPT option {k!r} has no equivalent; ignored")
    return IPOptions(**{**base.__dict__, **kwargs})


def solve(system, guess, optimizer_options=None, *, device="cuda", dtype=None):
    """Solve the system (IPOPT-adapter-compatible signature); ``device`` and
    ``dtype`` as :func:`pockit_tpu_torch.optimizer.ipm.solve`."""
    return ipm.solve(
        system, guess, _translate(optimizer_options, dtype), device=device, dtype=dtype
    )
