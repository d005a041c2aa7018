"""Multi-process initialization and mesh construction.

The port of ``pockit_tpu/parallel/distributed.py`` on ``torch.distributed``:
every process runs the same program, :func:`initialize_distributed` joins
the processes into one process group, and :func:`instance_mesh` lays the
group's ranks out as a ``(dp, ep)`` ``DeviceMesh``. The sharded solvers
(``parallel/sharding.py``, ``solver/structured.py``) are written against
the mesh, so going from one card to many is a change of launch, not of
code.

Torch has no virtual devices: a rank is a process, and one process drives
one card (or, with gloo, the CPU).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# environment markers of launchers whose processes ``env://`` can wire up:
# torchrun (WORLD_SIZE with MASTER_ADDR), SLURM and OpenMPI
_CLUSTER_ENV_MARKERS = ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")


def _on_scheduled_launch() -> bool:
    """True when the environment shows a multi-process launch."""
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return True
    return any(m in os.environ for m in _CLUSTER_ENV_MARKERS)


def _scheduled_rank_and_size():
    """``(rank, world_size)`` from the launcher's variables; ``env://``
    reads ``RANK`` / ``WORLD_SIZE`` itself when they are set."""
    for rank_var, size_var in (
        ("RANK", "WORLD_SIZE"),
        ("SLURM_PROCID", "SLURM_NTASKS"),
        ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
    ):
        if rank_var in os.environ and size_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ[size_var])
    return None, None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join this process to the default process group; returns True if it
    initialized one.

    Three cases, as in the JAX package:

    - explicit arguments -> ``init_process_group`` with exactly those
      values (``coordinator_address`` is ``host:port``, or an
      ``init_method`` URL such as ``tcp://host:port`` or ``file:///path``);
    - no arguments on a scheduled launch (torchrun, SLURM, OpenMPI,
      detected by their environment variables) -> ``env://``, with the
      rank and world size of the launcher;
    - no arguments on a plain host -> no-op.

    ``num_processes <= 1`` is a no-op too. ``backend`` is passed to
    ``init_process_group`` (``None``: gloo for CPU tensors and NCCL for
    CUDA tensors).
    """
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is not None or num_processes is not None:
        init_method = coordinator_address
        if init_method is not None and "://" not in init_method:
            init_method = f"tcp://{init_method}"
        dist.init_process_group(
            backend=backend, init_method=init_method,
            world_size=num_processes, rank=process_id,
        )
        return True
    if _on_scheduled_launch():
        if dist.is_initialized():
            # a group exists already: unattended single-process runs keep
            # working, a real launch surfaces the misuse loudly
            warnings.warn(
                "initialize_distributed auto-detect skipped: the default "
                "process group is already initialized",
                RuntimeWarning,
                stacklevel=2,
            )
            return False
        rank, size = _scheduled_rank_and_size()
        dist.init_process_group(
            backend=backend, init_method="env://", world_size=size, rank=rank
        )
        return True
    return False


def instance_mesh(
    axis_names: Sequence[str] = ("dp", "ep"),
    ep_size: int = 1,
    device_type: str = "cuda",
) -> DeviceMesh:
    """The ``(world // ep_size, ep_size)`` mesh of every rank, named
    ``axis_names``.

    ``ep_size`` splits off an ensemble / parameter-sweep axis; the rest of
    the ranks form the data-parallel axis. In a process with no process
    group it makes a one-rank group itself (NCCL for ``"cuda"``, gloo for
    ``"cpu"``, over an in-memory store), so one card works as the JAX mesh
    of one chip does; call :func:`initialize_distributed` first for many.
    ``device_type`` is the card unless the caller asks for ``"cpu"``.
    """
    if not dist.is_initialized():
        if device_type == "cuda":
            # raises where there is no card; the group and the mesh keep
            # the card this process has chosen
            torch.cuda.init()
        dist.init_process_group(
            backend="nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0,
        )
    n = dist.get_world_size()
    if n % ep_size:
        raise ValueError(f"device count {n} not divisible by ep_size {ep_size}")
    return init_device_mesh(
        device_type, (n // ep_size, ep_size), mesh_dim_names=tuple(axis_names)
    )
