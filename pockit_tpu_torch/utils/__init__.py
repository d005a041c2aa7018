"""Auxiliary subsystems: checkpointing, profiling and ahead-of-time solver
artifacts.

The names load on first access, so loading an artifact (``utils.aot``)
does not load the frontend that checkpointing imports.
"""

_NAMES = {
    "save_solution": "checkpoint",
    "load_solution": "checkpoint",
    "profile_trace": "profiling",
    "span": "profiling",
    "count": "profiling",
    "recording": "profiling",
    "export_batch_solver": "aot",
    "save_batch_solver": "aot",
    "load_batch_solver": "aot",
}

__all__ = list(_NAMES)


def __getattr__(name):
    if name in _NAMES:
        import importlib

        return getattr(importlib.import_module(f"pockit_tpu_torch.utils.{_NAMES[name]}"), name)
    raise AttributeError(f"module 'pockit_tpu_torch.utils' has no attribute {name!r}")
