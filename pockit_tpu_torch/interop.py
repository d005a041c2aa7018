"""State carried between the JAX package and the port, as numpy.

This system has no learned weights: its "parameters" are the problem
instance and the solver state. These helpers turn the reference's values
(``pockit_tpu``'s options, guess batches, bounds and runtime boundary
values, all as numpy) into the port's tensors, and the port's results back
into numpy for comparison. Nothing here imports ``jax``: a reference
``IPOptions`` is read through its dataclass fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pockit_tpu_torch.solver import Bounds, IPOptions, IPResult


def options_from_reference(opts) -> IPOptions:
    """The port's :class:`IPOptions` with every field of ``opts``, a
    reference ``pockit_tpu.solver.IPOptions`` or a dict of its fields.
    Raises ``ValueError`` on a field the port does not know."""
    if dataclasses.is_dataclass(opts):
        opts = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    known = {f.name for f in dataclasses.fields(IPOptions)}
    unknown = set(opts) - known
    if unknown:
        raise ValueError(f"unknown IPOptions fields: {sorted(unknown)}")
    return IPOptions(**opts)


def inputs_from_numpy(z0, bounds=None, bc_overrides=None, *, device="cuda", dtype=torch.float64):
    """``(z0 (B, L), bounds, bc)`` as tensors on ``device`` (the card
    unless ``device="cpu"``) in ``dtype``.

    ``bounds`` is any 4-sequence ``(z_lb, z_ub, c_lb, c_ub)`` (the
    reference's ``Bounds``), optionally batched; ``bc_overrides`` one
    ``(B, n_fixed)`` array per phase. ``None`` passes through."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    z0_t = t(z0)
    bounds_t = None if bounds is None else Bounds(*(t(b) for b in bounds))
    bc_t = None if bc_overrides is None else tuple(t(v) for v in bc_overrides)
    return z0_t, bounds_t, bc_t


def result_to_numpy(res: IPResult) -> dict:
    """Every :class:`IPResult` field as a host numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}
