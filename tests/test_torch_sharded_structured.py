"""The port's time-axis-sharded structured solve on the CPU, on two ranks.

The JAX package's three systems (``tests/test_parallel/
test_sharded_structured.py``): the 16x7 orbit transfer, the 8x6 LQR and a
ragged 8-interval layout. Each condensed ``K`` is built as the JAX test
builds it, from the JAX package's Hessian and Jacobian at a random point;
the port's layout of the same system must equal the JAX package's. Two
worker processes join one gloo group through a ``FileStore`` under the
test's directory, and each solves every system with its half of the
interior blocks; one spawn carries every two-rank check.

Tolerances: against ``np.linalg.solve`` rtol 1e-8, atol 1e-9 (the JAX
test's); against the JAX package's sharded solve on its 8-device virtual
CPU mesh and against the port's unsharded ``make_structured_solve``, atol
1e-9 and 1e-10.
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch
from jax.sharding import Mesh

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
from pockit_tpu.solver.structured import make_sharded_structured_solve as ref_sharded_solve
from pockit_tpu.solver.structured import structured_layout as ref_layout
from pockit_tpu_torch.solver.structured import make_structured_solve, structured_layout

from test_torch_sharding import ROOT, spawn_ranks

_WORKER = textwrap.dedent(
    """
    import gc, os, sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from pockit_tpu_torch.parallel import initialize_distributed, make_sharded_structured_solve
    from pockit_tpu_torch.solver.structured import StructuredLayout

    rank, world, store, data, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    assert initialize_distributed("file://" + store, num_processes=world, process_id=rank, backend="gloo")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("time",))
    inp = np.load(data)
    res = {{}}
    for name in inp["names"]:
        layout = StructuredLayout(inp[name + "_interior"], inp[name + "_reduced"], 0, int(inp[name + "_n"]))
        solve = make_sharded_structured_solve(layout, mesh, "time")
        res[name] = solve(torch.as_tensor(inp[name + "_K"]), torch.as_tensor(inp[name + "_rhs"])).numpy()

    def raises(exc, text, *args, **kw):
        try:
            make_sharded_structured_solve(*args, **kw)
        except exc as e:
            return text in str(e)
        return False

    lay = StructuredLayout(inp["lqr_interior"], inp["lqr_reduced"], 0, int(inp["lqr_n"]))
    checks = [
        raises(NotImplementedError, "not ported", lay, mesh, "time", method="unrolled"),
        raises(ValueError, "unknown method", lay, mesh, "time", method="pallas"),
        raises(ValueError, "not divisible", lay._replace(interior=lay.interior[:3]), mesh, "time"),
        raises(ValueError, "exact block-arrow", lay._replace(krylov_rank=1), mesh, "time"),
    ]
    np.savez(out, checks=np.array(checks), **res)
    # drop the meshes and what holds their groups first: a gloo group that
    # outlives destroy_process_group into interpreter exit can abort the process
    del mesh, solve
    gc.collect()
    dist.destroy_process_group()
    """
)


def _orbit():
    out = []
    for mod in (ref_lobatto, port_lobatto):
        system = mod.System(["r_f"])
        (r_f,) = system.s
        phase = system.new_phase(["r", "u", "v"], ["phi"])
        r, u, v = phase.x
        (phi,) = phase.u
        acc = 0.1405 / (1 - 0.0749 * phase.t)
        phase.set_dynamics(
            [u, v**2 / r - 1 / r**2 + acc * sp.sin(phi), -u * v / r + acc * sp.cos(phi)]
        )
        phase.set_boundary_condition([1.0, 0.0, 1.0], [r_f, 0.0, 1 / sp.sqrt(r_f)], 0.0, 3.32)
        phase.set_discretization(16, 7)  # 16 intervals -> 8 per rank
        system.set_phase([phase])
        system.set_objective(-r_f)
        out.append(system)
    return out


def _lqr():
    out = []
    for mod in (ref_lobatto, port_lobatto):
        system = mod.System([])
        phase = system.new_phase(["x"], ["u"])
        (x,) = phase.x
        (u,) = phase.u
        phase.set_dynamics([-x + u])
        phase.set_integral([x**2 + u**2])
        phase.set_boundary_condition([1.0], [None], 0.0, 1.0)
        phase.set_discretization(8, 6)
        system.set_phase([phase])
        system.set_objective(phase.I[0])
        out.append(system)
    return out


def _ragged():
    out = []
    for mod in (ref_lobatto, port_lobatto):
        system = mod.System(["x_f"])
        (x_f,) = system.s
        phase = system.new_phase(["x", "v"], ["u"])
        x, v = phase.x
        (u,) = phase.u
        phase.set_dynamics([v, -x + u])
        phase.set_integral([x**2 + 0.1 * u**2])
        phase.set_boundary_condition([1.0, 0.0], [x_f, None], 0.0, 1.0)
        phase.set_discretization(np.linspace(0.0, 1.0, 9), np.array([5, 6, 5, 6, 5, 6, 5, 6]))
        system.set_phase([phase])
        system.set_objective(phase.I[0] + x_f**2 / 2)
        out.append(system)
    return out


_SYSTEMS = {"orbit": (_orbit, 0), "lqr": (_lqr, 3), "ragged": (_ragged, 4)}


def _condensed_K(system, seed):
    """The JAX test's K: W + diag + J^T D J at a random point, shifted SPD."""
    rng = np.random.default_rng(seed)
    compiled = system.compiled
    z = rng.uniform(0.5, 1.2, system.L)
    lam = rng.normal(0, 1, compiled.m)
    W = np.asarray(compiled.hessian(z, lam, 1.0))
    J = np.asarray(compiled.jacobian(z))
    K = W + np.diag(rng.uniform(0.1, 5.0, system.L)) + (J.T * rng.uniform(0.1, 10.0, compiled.m)) @ J
    ev = np.linalg.eigvalsh(K)
    if ev.min() < 1e-6:
        K = K + (1e-3 - min(ev.min(), 0)) * np.eye(system.L)
    return K, rng.normal(size=system.L)


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, (build, seed) in _SYSTEMS.items():
        ref_sys, port_sys = build()
        lay_r, lay_p = ref_layout(ref_sys), structured_layout(port_sys)
        np.testing.assert_array_equal(lay_p.interior, lay_r.interior)
        np.testing.assert_array_equal(lay_p.reduced, lay_r.reduced)
        assert lay_p.krylov_rank == lay_r.krylov_rank == 0
        K, rhs = _condensed_K(ref_sys, seed)
        out[name] = (ref_sys, lay_r, lay_p, K, rhs)
    assert (np.asarray(out["ragged"][2].interior) >= out["ragged"][0].L).any()
    return out


@pytest.fixture(scope="module")
def two_ranks(problems, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_structured")
    arrays = {"names": np.array(list(problems))}
    for name, (ref_sys, _, lay, K, rhs) in problems.items():
        arrays.update({name + "_interior": lay.interior, name + "_reduced": lay.reduced,
                       name + "_n": lay.n_cols, name + "_K": K, name + "_rhs": rhs})
    np.savez(tmp / "inputs.npz", **arrays)
    return spawn_ranks(tmp, _WORKER.format(root=ROOT), 2, tmp / "inputs.npz")


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("name", list(_SYSTEMS))
def test_two_ranks_match_dense_and_reference(name, problems, two_ranks):
    ref_sys, lay_r, lay_p, K, rhs = problems[name]
    x_dense = np.linalg.solve(K, rhs)
    x_un, _, _ = make_structured_solve(lay_p)(torch.as_tensor(K), torch.as_tensor(rhs))
    for r in two_ranks:  # every rank returns the whole x
        np.testing.assert_allclose(r[name], x_dense, rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(r[name], x_un.numpy(), rtol=0, atol=1e-10)
    mesh = Mesh(np.array(jax.devices()[:8]), ("time",))
    want = jax.jit(ref_sharded_solve(lay_r, mesh, "time", method="lax"))(jnp.asarray(K), jnp.asarray(rhs))
    np.testing.assert_allclose(two_ranks[0][name], np.asarray(want), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(two_ranks[0][name], two_ranks[1][name])


def test_unported_method_and_bad_layouts_raise(two_ranks):
    """C2 and C4: "unrolled" raises as ``block_core="unrolled"`` does; an
    unknown method, interiors the axis does not divide and an inexact
    pattern raise ``ValueError``."""
    for r in two_ranks:
        assert r["checks"].tolist() == [True, True, True, True]
