"""Auxiliary subsystems: checkpointing and profiling."""

from pockit_tpu_torch.utils.checkpoint import load_solution, save_solution
from pockit_tpu_torch.utils.profiling import profile_trace

__all__ = ["save_solution", "load_solution", "profile_trace"]
