"""Homotopy / continuation sweeps over batched problem instances.

The port of ``pockit_tpu/parallel/homotopy.py``. A continuation sweep
solves a family of problems along a parameter path (e.g. ramping a
boundary condition), warm-starting every stage from the previous stage's
solutions. Each stage is one batched solve on the sweep's device; stage
k+1 chains on stage k's ``res.z`` there, with no host copy except on the
checkpoint's warm-save stages.

Long sweeps are durable: pass ``checkpoint_path`` and completed stages are
persisted incrementally (one small per-stage summary file per stage, the
(B, L) warm-start batch overwritten in place, and a manifest renamed last
as the commit point). Re-running the same sweep after a kill resumes from
the last stage with a saved warm-start batch. The directory is the JAX
package's format, file for file and key for key, with the same
fingerprint over the float64 bytes of the inputs: a sweep killed under
one package resumes under the other.
"""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.solver import IPOptions


class StageSummary(NamedTuple):
    """Record returned for stages restored from a sweep checkpoint (full
    ``IPResult`` traces and duals are not kept across a restart). Host
    numpy arrays."""

    status: np.ndarray
    obj: np.ndarray
    iterations: np.ndarray
    kkt_error: np.ndarray
    z: Optional[np.ndarray]  # warm-start batch; kept for the last stage only


def _host(a) -> np.ndarray:
    """A caller's array (numpy, or a tensor on any device) on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _sweep_digest(guess_batch, bc_stages) -> str:
    """Fingerprint of the sweep definition, so a stale checkpoint from a
    different sweep is never silently resumed: the shapes and float64 bytes
    of the inputs, as the JAX package computes it."""
    h = hashlib.sha1()
    g = _host(guess_batch)
    h.update(str(g.shape).encode())
    h.update(np.ascontiguousarray(g, dtype=np.float64).tobytes())
    for bc in bc_stages:
        for arr in bc:
            a = _host(arr)
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a, dtype=np.float64).tobytes())
    return h.hexdigest()


def _atomic_savez(path, **arrays):
    # suffix must stay ".npz" or np.savez appends one to the tmp name
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _stage_file(ckdir, k):
    return os.path.join(ckdir, f"stage_{k:05d}.npz")


def _commit_stage(ckdir, digest, k, res, warm_stage):
    """Persist stage ``k``: one O(B) summary file (``res``'s tensors copied
    to the host), the (B, L) warm batch iff ``warm_stage == k``, then the manifest
    rename as the commit point. Every write is write-to-temp + rename, so a
    kill at any point leaves the previous commit intact."""
    _atomic_savez(
        _stage_file(ckdir, k),
        status=res.status.cpu().numpy(),
        obj=res.obj.cpu().numpy(),
        iterations=res.iterations.cpu().numpy(),
        kkt_error=res.kkt_error.cpu().numpy(),
    )
    if warm_stage == k:
        _atomic_savez(os.path.join(ckdir, "warm.npz"), z=res.z.cpu().numpy())
    _atomic_savez(
        os.path.join(ckdir, "manifest.npz"),
        digest=np.frombuffer(digest.encode(), dtype=np.uint8),
        stage=np.asarray(k),
        warm_stage=np.asarray(warm_stage),
    )


def _load_manifest(ckdir):
    """Returns (digest, warm_stage, stage) or (None, -1, -1)."""
    path = os.path.join(ckdir, "manifest.npz")
    if not os.path.exists(path):
        return None, -1, -1
    with np.load(path) as f:
        return (
            bytes(f["digest"]).decode(),
            int(f["warm_stage"]),
            int(f["stage"]),
        )


def homotopy_sweep(
    system,
    guess_batch,
    bc_stages: Sequence,
    optimizer_options: Optional[IPOptions] = None,
    on_stage: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    checkpoint_every: int = 1,
    *,
    device=None,
    dtype=None,
):
    """Solve a batched continuation sweep.

    Args:
        system: fully configured ``System``.
        guess_batch: (B, L) initial vectors for stage 0 (numpy, or a
            tensor).
        bc_stages: sequence of per-stage ``bc_overrides`` (each a tuple of
            (B, n_fixed) arrays, one per phase) describing the continuation
            path of the FIXED boundary values.
        optimizer_options: shared solver options.
        on_stage: optional callback ``(stage_index, IPResult) -> None``.
            Not invoked for stages restored from a checkpoint.
        checkpoint_path: when set, a checkpoint DIRECTORY: each completed
            stage appends one small summary file and atomically updates the
            warm-start batch + manifest (the manifest rename is the commit
            point).
        resume: when True (default) and ``checkpoint_path`` holds a
            checkpoint whose fingerprint matches this sweep, completed
            stages are skipped and the sweep continues from the saved
            warm-start batch. A non-matching checkpoint is ignored, with a
            warning (the sweep restarts from stage 0 and overwrites it).
        checkpoint_every: persist the (B, L) warm-start batch only every
            N-th stage (summaries are still written every stage); resume
            then re-solves at most ``checkpoint_every - 1`` stages. The
            final stage always saves the batch.
        device, dtype: where and in which precision to solve, as
            :func:`~pockit_tpu_torch.optimizer.ipm.solve_batch` (a numpy
            ``guess_batch`` goes to the card unless ``device="cpu"``); a
            restored warm batch is uploaded there in that type.

    Returns:
        list of per-stage results: restored stages appear as
        :class:`StageSummary`, freshly solved stages as full ``IPResult``;
        stage k+1 warm-starts from stage k's primal solutions.
    """
    bc_stages = list(bc_stages)
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    digest = _sweep_digest(guess_batch, bc_stages) if checkpoint_path else None
    results: list = []
    start = 0
    z = ipm._as_batch(guess_batch, device, dtype)

    if checkpoint_path and resume:
        saved_digest, warm_stage, _ = _load_manifest(checkpoint_path)
        if saved_digest is not None and saved_digest == digest and warm_stage >= 0:
            # resume from the last stage with a saved warm batch: stages
            # after it (summary-only commits) are re-solved
            start = warm_stage + 1
            with np.load(os.path.join(checkpoint_path, "warm.npz")) as f:
                z_host = np.asarray(f["z"])
            z = torch.as_tensor(z_host, device=z.device, dtype=z.dtype)
            for k in range(start):
                with np.load(_stage_file(checkpoint_path, k)) as f:
                    results.append(
                        StageSummary(
                            status=np.asarray(f["status"]),
                            obj=np.asarray(f["obj"]),
                            iterations=np.asarray(f["iterations"]),
                            kkt_error=np.asarray(f["kkt_error"]),
                            z=z_host if k == start - 1 else None,
                        )
                    )
        elif saved_digest is not None and saved_digest != digest:
            warnings.warn(
                "homotopy checkpoint at "
                f"{checkpoint_path!r} belongs to a different sweep "
                "(fingerprint mismatch); restarting from stage 0"
            )

    if checkpoint_path:
        os.makedirs(checkpoint_path, exist_ok=True)
    last_warm = start - 1  # stage whose z is in warm.npz; -1 = none yet

    for k in range(start, len(bc_stages)):
        res = ipm.solve_batch(
            system,
            z,
            bc_overrides=bc_stages[k],
            optimizer_options=optimizer_options,
        )
        if checkpoint_path:
            # durability costs one host copy of the O(B) stage summaries;
            # the (B, L) warm batch is copied only on warm-save stages
            save_warm = (
                (k - start) % checkpoint_every == checkpoint_every - 1
                or k == len(bc_stages) - 1
            )
            if save_warm:
                last_warm = k
            _commit_stage(checkpoint_path, digest, k, res, last_warm)
        if on_stage is not None:
            on_stage(k, res)
        results.append(res)
        z = res.z
    return results
