"""Solver interfaces.

- :mod:`pockit_tpu_torch.optimizer.ipm`: the native batched interior-point
  solver.
- :mod:`pockit_tpu_torch.optimizer.scipy`: scipy ``trust-constr`` adapter,
  kept as an independent cross-check of the transcription.
- :mod:`pockit_tpu_torch.optimizer.ipopt`: drop-in shim translating
  IPOPT-style option dicts so reference scripts run by changing only the
  package name.
"""

from pockit_tpu_torch.optimizer import ipm, ipopt, scipy  # noqa: F401

__all__ = ["ipm", "ipopt", "scipy"]
