"""Auxiliary subsystems: checkpointing."""

from pockit_tpu_torch.utils.checkpoint import load_solution, save_solution

__all__ = ["save_solution", "load_solution"]
