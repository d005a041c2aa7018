"""Instance sweeps on one device: batched hp-refinement over per-instance
meshes (:func:`solve_refine_batch`) and homotopy continuation with durable
checkpoints (:func:`homotopy_sweep`).

The port of the part of ``pockit_tpu/parallel`` that runs on one device;
the multi-device layers (``sharding``, ``distributed``) are not ported
yet.
"""

from pockit_tpu_torch.parallel.homotopy import homotopy_sweep
from pockit_tpu_torch.parallel.refine_batch import SweepResult, solve_refine_batch

__all__ = ["homotopy_sweep", "solve_refine_batch", "SweepResult"]
