"""scipy ``trust-constr`` adapter.

The port of ``pockit_tpu/optimizer/scipy.py``, kept as an independent
cross-check of the transcription: it consumes the same NLP callbacks as
the native interior-point solver (``compiled.objective`` ... ``hessian``,
evaluated in float64 on ``device``, the card unless ``device="cpu"``, and
copied to the host per callback) but optimizes with scipy's solver, so
agreement between the two validates both. Jacobian and Hessian are passed
dense: the problems this adapter is used for are small.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.optimize import Bounds as ScipyBounds
from scipy.optimize import NonlinearConstraint, minimize

from pockit_tpu_torch.base.system import SystemBase
from pockit_tpu_torch.optimizer._common import postprocess, preprocess


def solve(
    system: SystemBase,
    guess,
    optimizer_options: Optional[dict] = None,
    *,
    device="cuda",
):
    """Solve the system using scipy's trust-constr method.

    Same calling convention as :func:`pockit_tpu_torch.optimizer.ipm.solve`;
    ``optimizer_options`` are passed verbatim to ``scipy.optimize.minimize``.
    Returns ``(result, scipy_result)``.
    """
    x_0, guess_is_variable = preprocess(system, guess)
    if optimizer_options is None:
        optimizer_options = {}

    compiled = system.compiled
    num_cons = len(compiled.c_lb)
    rt = compiled.default_runtime(device)
    host = lambda t: t.detach().cpu().numpy()

    constraints = []
    if num_cons:
        constraints.append(
            NonlinearConstraint(
                lambda x: host(compiled.constraints(x, rt, device)),
                compiled.c_lb,
                compiled.c_ub,
                jac=lambda x: host(compiled.jacobian(x, rt, device)),
                hess=lambda x, v: host(compiled.hessian(x, v, 0.0, rt, device)),
            )
        )

    res = minimize(
        lambda x: float(compiled.objective(x, rt, device)),
        x_0,
        method="trust-constr",
        jac=lambda x: host(compiled.gradient(x, rt, device)),
        hess=lambda x: host(compiled.hessian(x, np.zeros(num_cons), 1.0, rt, device)),
        constraints=constraints,
        bounds=ScipyBounds(compiled.z_lb, compiled.z_ub),
        options=optimizer_options,
    )

    Variable = type(guess) if guess_is_variable else type(guess[0])
    result = postprocess(Variable, system, res.x, guess_is_variable)
    return result, res
