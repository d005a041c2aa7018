"""Checkpoint / resume for solve-refine loops.

The port of ``pockit_tpu/utils/checkpoint.py``, in the same file format,
so each package reads the other's checkpoints. A ``Variable``'s flat data
vector is the complete warm-start state; a checkpoint holds it with the
mesh that gives it meaning: per-phase data vectors, mesh points, degrees,
and the static-parameter array, as one ``.npz``. Loading re-applies each
phase's stored mesh (so a refine-loop checkpoint resumes mid-loop) and
rewraps ``Variable`` objects.
"""

from __future__ import annotations

import numpy as np

from pockit_tpu_torch.base.variable import VariableBase


def save_solution(path: str, system, value) -> None:
    """Save a solution/guess (the ``value`` format of ``check``/``refine``:
    a single Variable, or per-phase Variables + statics array)."""
    single = isinstance(value, VariableBase)
    if single and system.n_s > 0:
        raise ValueError(
            "system has static parameters: pass [*variables, statics], not a "
            "bare Variable (a bare Variable would round-trip to a malformed "
            "guess)"
        )
    vars_ = [value] if single else list(value[: system.n_p])
    statics = (
        np.zeros(0)
        if (single or system.n_s == 0)
        else np.array(list(value[-1]), dtype=np.float64)
    )
    payload = {"n_p": np.array(system.n_p), "statics": statics}
    for i, v in enumerate(vars_):
        payload[f"data_{i}"] = np.asarray(v.data)
        payload[f"mesh_{i}"] = np.asarray(v._mesh)
        payload[f"num_point_{i}"] = np.asarray(v._num_point)
    np.savez(path, **payload)


def load_solution(path: str, system):
    """Load a checkpoint, re-applying each phase's stored mesh.

    Returns the ``value`` in the same format ``save_solution`` received
    (single Variable when the system has one phase and no statics).
    """
    with np.load(path) as f:
        n_p = int(f["n_p"])
        if n_p != system.n_p:
            raise ValueError(
                f"checkpoint has {n_p} phases, system has {system.n_p}"
            )
        out = []
        for i, phase in enumerate(system.p):
            mesh = f[f"mesh_{i}"]
            num_point = f[f"num_point_{i}"]
            if (
                phase.N != len(num_point)
                or not np.array_equal(phase._mesh, mesh)
                or not np.array_equal(phase._num_point, num_point)
            ):
                phase.set_discretization(mesh, num_point)
        system.update()
        # the scheme's Variable class, from the phase's family
        for i, phase in enumerate(system.p):
            if phase._family == "lobatto":
                from pockit_tpu_torch.lobatto import Variable
            else:
                from pockit_tpu_torch.radau import Variable
            out.append(Variable(phase, f[f"data_{i}"]))
        statics = f["statics"]
    if system.n_s == 0 and system.n_p == 1:
        return out[0]
    if system.n_s:
        return out + [statics]
    return out
