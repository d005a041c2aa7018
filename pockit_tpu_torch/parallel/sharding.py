"""Sharded batched solves over a ``DeviceMesh``.

The port of ``pockit_tpu/parallel/sharding.py``. The batch (instance) axis
is the scaling axis: instances are independent during the solve, so each
rank solves its own rows with the port's batch-first solver (on the card,
the block-arrow CUDA kernels), and the only traffic between ranks is one
``all_reduce`` of the convergence count.

Rank layout: the mesh's ``(dp, ep)`` ranks, flattened row-major, hold the
global batch in order: the rank at flat position ``r`` of ``n`` holds rows
``[r·B/n, (r+1)·B/n)``, the order ``P(("dp", "ep"))`` lays a global array
out over the JAX mesh. :func:`local_rows` gives that slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from pockit_tpu_torch.optimizer.ipm import _solver_for, default_options
from pockit_tpu_torch.solver import Bounds, IPOptions


def _mesh_ranks(mesh):
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def local_rows(batch_size: int, mesh) -> slice:
    """This rank's rows ``[r·B/n, (r+1)·B/n)`` of a global batch of
    ``batch_size`` over every rank of ``mesh``; ``ValueError`` when the
    mesh does not divide the batch."""
    ranks = _mesh_ranks(mesh)
    n = len(ranks)
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by the mesh's {n} ranks")
    r = ranks.index(dist.get_rank())
    b = batch_size // n
    return slice(r * b, (r + 1) * b)


def make_sharded_batch_solver(compiled, mesh, options: Optional[IPOptions] = None):
    """Build ``step(z0, bounds, rt) -> (IPResult, n_converged)`` over every
    rank of ``mesh``.

    Every rank calls ``step`` with its own rows (:func:`local_rows`):
    ``z0 (b, L)``, ``bounds`` and ``rt`` leaves with the same leading
    ``b``, and gets back the ``IPResult`` of those rows. ``n_converged`` is
    the count of converged lanes over the whole mesh (a 0-d int64 tensor on
    every rank), the cross-rank convergence signal for sweep drivers. A
    global batch that the mesh does not divide (ranks holding different
    row counts) raises ``ValueError`` on every rank.
    """
    if options is None:
        options = default_options()
    # the solver solve_batch builds and caches for these options: the
    # block-arrow kernels on the card's block paths
    _, solve_fn, _ = _solver_for(compiled.system, options)
    ranks = _mesh_ranks(mesh)
    n = len(ranks)
    # the whole world is the default group; a sub-mesh gets its own (made
    # here, where every rank calls in, as new_group requires)
    group = None if ranks == list(range(dist.get_world_size())) else dist.new_group(ranks)

    def step(z0, bounds: Bounds, rt):
        res = solve_fn(z0, Bounds(*bounds), rt)
        b = z0.shape[0]
        # one all_reduce of (converged, rows, rows^2). The tensor stays on
        # the solve's device: NCCL takes only CUDA tensors and gloo takes
        # both. Equal row counts on every rank is n * sum(b^2) == sum(b)^2,
        # which every rank reads alike.
        counts = torch.tensor([0, b, b * b], dtype=torch.int64, device=z0.device)
        counts[0] = (res.status == 0).sum()
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        n_conv, rows, rows_sq = counts.tolist()
        if n * rows_sq != rows * rows:
            raise ValueError(
                f"batch {rows} not divisible by the mesh's {n} ranks "
                f"(this rank holds {b} rows)"
            )
        return res, counts[0]

    step.kkt_path = solve_fn.kkt_path
    return step


def replicate_for_batch(tree, B: int):
    """Broadcast every tensor (or array) leaf of ``tree`` to a leading batch
    axis of ``B``."""

    def bcast(v):
        if isinstance(v, torch.Tensor):
            return torch.broadcast_to(v, (B,) + tuple(v.shape))
        v = np.asarray(v)
        return np.broadcast_to(v, (B,) + v.shape)

    return tree_map(bcast, tree)
