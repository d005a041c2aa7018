"""Legendre-Gauss-Radau pseudospectral scheme.

Suitable for continuous or discontinuous (bang-bang) problems: controls keep
separate points per interval so the interpolant can jump at mesh points
(the port of ``pockit_tpu/radau/__init__.py``).
"""

from functools import partial

import numpy as np

from pockit_tpu_torch.base.phase import PhaseBase
from pockit_tpu_torch.base.system import SystemBase
from pockit_tpu_torch.base.variable import (
    VariableBase,
    constant_guess_base,
    linear_guess_base,
)


class Phase(PhaseBase):
    """LGR phase: states carry one extra terminal point; controls are
    per-interval (non-shared)."""

    _family = "radau"


class Variable(VariableBase):
    """LGR variable: shared-border states (num_point + 1 points each
    interval), block-diagonal controls."""

    def _assemble_x(self, blocks) -> np.ndarray:
        return self._assemble_c(self._num_point + 1, blocks)

    def _assemble_u(self, blocks) -> np.ndarray:
        return self._assemble_nc(blocks)


class System(SystemBase):
    """LGR system."""

    _class_phase = Phase


constant_guess = partial(constant_guess_base, Variable)
linear_guess = partial(linear_guess_base, Variable)

__all__ = ["Phase", "System", "Variable", "constant_guess", "linear_guess"]
