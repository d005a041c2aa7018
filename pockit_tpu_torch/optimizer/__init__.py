"""Solver interfaces.

- :mod:`pockit_tpu_torch.optimizer.ipm`: the native batched interior-point
  solver.
- :mod:`pockit_tpu_torch.optimizer.scipy`: scipy ``trust-constr`` adapter,
  kept as an independent cross-check of the transcription.
- :mod:`pockit_tpu_torch.optimizer.ipopt`: drop-in shim translating
  IPOPT-style option dicts so reference scripts run by changing only the
  package name.

The submodules load on first access, so ``optimizer.ipm`` (which a system
loaded from solver artifacts solves through) does not load the frontend
that the adapters import.
"""

__all__ = ["ipm", "ipopt", "scipy"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"pockit_tpu_torch.optimizer.{name}")
    raise AttributeError(f"module 'pockit_tpu_torch.optimizer' has no attribute {name!r}")
