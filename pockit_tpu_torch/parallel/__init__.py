"""Multi-device scaling and instance sweeps.

The port of ``pockit_tpu/parallel`` on ``torch.distributed``: instance
sharding over a ``DeviceMesh`` (:func:`make_sharded_batch_solver`, one
``all_reduce`` of the convergence count), the time axis of one instance
over ranks (:func:`make_sharded_structured_solve`), process-group
initialization and the ``(dp, ep)`` mesh (:func:`initialize_distributed`,
:func:`instance_mesh`), batched hp-refinement over per-instance meshes
(:func:`solve_refine_batch`) and homotopy continuation with durable
checkpoints (:func:`homotopy_sweep`).

A rank is a process: torch has no ``shard_map``, so each rank calls the
solvers with its own rows and the collectives are explicit. The JAX
package's ``parallel/_compat.py``, which papers over ``shard_map``'s
renames between jax versions, has no counterpart.
"""

from pockit_tpu_torch.parallel.distributed import initialize_distributed, instance_mesh
from pockit_tpu_torch.parallel.homotopy import homotopy_sweep
from pockit_tpu_torch.parallel.refine_batch import SweepResult, solve_refine_batch
from pockit_tpu_torch.parallel.sharding import make_sharded_batch_solver
from pockit_tpu_torch.solver.structured import make_sharded_structured_solve

__all__ = [
    "make_sharded_batch_solver",
    "make_sharded_structured_solve",
    "initialize_distributed",
    "instance_mesh",
    "homotopy_sweep",
    "solve_refine_batch",
    "SweepResult",
]
