"""Host-side numerics: quadrature nodes/weights, Lagrange interpolation,
mesh index layout.

The port's own copy of ``pockit_tpu/numerics`` (its numpy path only).
Everything here runs in float64 numpy on the host at problem-construction
time.
"""

from pockit_tpu_torch.numerics.layout import lr_c, lr_nc
from pockit_tpu_torch.numerics.quadrature import xw_lgl, xw_lgr
from pockit_tpu_torch.numerics.lagrange import (
    barycentric_weights,
    lagrange_values,
    differentiation_matrix,
    integral_matrix,
    V_interpolation,
    D_interpolation,
    polynomial_coefficients,
)

__all__ = [
    "lr_c",
    "lr_nc",
    "xw_lgl",
    "xw_lgr",
    "barycentric_weights",
    "lagrange_values",
    "differentiation_matrix",
    "integral_matrix",
    "V_interpolation",
    "D_interpolation",
    "polynomial_coefficients",
]
