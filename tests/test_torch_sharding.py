"""The port's multi-device layer on the CPU: ``initialize_distributed``,
``instance_mesh``, ``replicate_for_batch`` and ``make_sharded_batch_solver``.

Torch has no virtual devices, so a rank is a process: two worker processes
join one gloo group through a ``FileStore`` under the test's directory
(no TCP port, so parallel test workers cannot collide), each solves its
rows of the README LQR 6x6 at B=16 in float64, and the rows are held lane
by lane against the JAX package's ``make_sharded_batch_solver`` on its 4x2
virtual-CPU mesh. One spawn of two ranks carries every two-rank check.

Tolerances: against the JAX package, obj rtol 1e-8 (the port's
cross-package LQR tolerance) with equal statuses; the one-rank solve in
process is bit for bit the port's ``solve_batch``; the converged count is
exact.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
import pockit_tpu_torch.parallel.distributed as port_dist
from pockit_tpu.optimizer._common import preprocess as ref_preprocess
from pockit_tpu.parallel import make_sharded_batch_solver as ref_sharded
from pockit_tpu.solver import Bounds as RefBounds
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer.ipm import default_options
from pockit_tpu_torch.parallel import (
    initialize_distributed,
    instance_mesh,
    make_sharded_batch_solver,
)
from pockit_tpu_torch.parallel.sharding import local_rows, replicate_for_batch
from pockit_tpu_torch.solver import Bounds, broadcast_bounds

from test_torch_frontend import build_lqr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16
WORKER_TIMEOUT = 120  # seconds, per spawn; every rank is killed past it

_WORKER = textwrap.dedent(
    """
    import gc, os, sys
    sys.path.insert(0, {root!r})
    sys.path.insert(0, os.path.join({root!r}, "tests"))
    import numpy as np
    import torch
    import torch.distributed as dist
    import pockit_tpu_torch.lobatto as lobatto
    from pockit_tpu_torch.optimizer.ipm import default_options
    from pockit_tpu_torch.parallel import initialize_distributed, instance_mesh, make_sharded_batch_solver
    from pockit_tpu_torch.parallel.sharding import local_rows
    from pockit_tpu_torch.solver import broadcast_bounds, Bounds
    from test_torch_frontend import build_lqr

    rank, world, store, data, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    assert initialize_distributed("file://" + store, num_processes=world, process_id=rank, backend="gloo")
    shapes = {{}}
    for ep in (1, 2):
        shapes[ep] = tuple(instance_mesh(ep_size=ep, device_type="cpu").mesh.shape)
    try:
        instance_mesh(ep_size=3, device_type="cpu")
        raised = False
    except ValueError as e:
        raised = "divisible" in str(e)
    mesh = instance_mesh(device_type="cpu")

    inp = np.load(data)
    system, _ = build_lqr(lobatto, 6, 6)
    c = system.compiled
    rows = local_rows(len(inp["z0"]), mesh)
    t = lambda a: torch.as_tensor(a[rows], dtype=torch.float64)
    z0, bc = t(inp["z0"]), t(inp["bc"])
    bounds0 = Bounds(*(torch.as_tensor(np.asarray(b, dtype=np.float64)) for b in (c.z_lb, c.z_ub, c.c_lb, c.c_ub)))
    step = make_sharded_batch_solver(c, mesh, default_options(torch.float64))
    res, n_conv = step(z0, broadcast_bounds(bounds0, z0.shape[0]), {{"bc": (bc,)}})
    try:  # rows the mesh does not divide: rank 0 holds 2 rows, rank 1 one
        step(z0[: 2 - rank], broadcast_bounds(bounds0, 2 - rank), {{"bc": (bc[: 2 - rank],)}})
        uneven = False
    except ValueError as e:
        uneven = "divisible" in str(e)
    try:
        local_rows(len(inp["z0"]) + 1, mesh)
        uneven = False
    except ValueError as e:
        uneven = uneven and "divisible" in str(e)
    np.savez(out, obj=res.obj.numpy(), z=res.z.numpy(), status=res.status.numpy(),
             iterations=res.iterations.numpy(), n_conv=int(n_conv), start=rows.start,
             shape_ep1=shapes[1], shape_ep2=shapes[2], ep3_raised=raised, uneven_raised=uneven)
    # drop the meshes and what holds their groups first: a gloo group that
    # outlives destroy_process_group into interpreter exit can abort the process
    del mesh, step
    gc.collect()
    dist.destroy_process_group()
    """
)


def spawn_ranks(tmp_path, script, world, *args):
    """Run ``script`` as ``world`` ranks that meet through a FileStore under
    ``tmp_path``; every rank is killed if one fails or the spawn outlasts
    ``WORKER_TIMEOUT``. Returns each rank's output file."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(path), str(r), str(world), str(store), *map(str, args), str(outs[r])],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    try:
        results = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{world} ranks outlasted {WORKER_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    return [np.load(o) for o in outs]


@pytest.fixture(scope="module")
def lqr_batch():
    ref_sys, ref_phase = build_lqr(ref_lobatto, 6, 6)
    x0, _ = ref_preprocess(ref_sys, [ref_lobatto.constant_guess(ref_phase, 0), [0.0]])
    bc = np.tile(ref_sys.compiled.phases[0].fixed_vals, (B, 1))
    bc[:, 0] = np.random.default_rng(0).uniform(0.5, 1.5, B)
    return ref_sys, np.tile(x0, (B, 1)), bc


@pytest.fixture(scope="module")
def two_ranks(lqr_batch, tmp_path_factory):
    _, z0, bc = lqr_batch
    tmp = tmp_path_factory.mktemp("sharding")
    data = tmp / "inputs.npz"
    np.savez(data, z0=z0, bc=bc)
    return spawn_ranks(tmp, _WORKER.format(root=ROOT), 2, data)


@pytest.fixture
def no_group():
    """Leaves the process with no default process group afterwards."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_ranks_match_the_reference_sharded_solve(lqr_batch, two_ranks):
    ref_sys, z0, bc = lqr_batch
    c = ref_sys.compiled
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("dp", "ep"))
    bounds = RefBounds(*(jnp.broadcast_to(jnp.asarray(b), (B,) + np.shape(b))
                         for b in (c.z_lb, c.z_ub, c.c_lb, c.c_ub)))
    want, want_conv = ref_sharded(c, mesh)(jnp.asarray(z0), bounds, {"bc": (jnp.asarray(bc),)})
    assert int(want_conv) == B

    # B1: rank r holds rows [r B/2, (r+1) B/2), the order P(("dp", "ep")) lays out
    assert [int(r["start"]) for r in two_ranks] == [0, B // 2]
    got = {k: np.concatenate([r[k] for r in two_ranks]) for k in ("obj", "z", "status")}
    np.testing.assert_array_equal(got["status"], np.asarray(want.status))
    np.testing.assert_allclose(got["obj"], np.asarray(want.obj), rtol=1e-8)
    # B3: the one all_reduce gives every rank the mesh's count
    assert [int(r["n_conv"]) for r in two_ranks] == [B, B]


def test_two_rank_meshes_and_uneven_batches(two_ranks):
    for r in two_ranks:
        assert tuple(r["shape_ep1"]) == (2, 1)
        assert tuple(r["shape_ep2"]) == (1, 2)
        assert bool(r["ep3_raised"])  # 2 ranks are not divisible by ep_size 3
        assert bool(r["uneven_raised"])  # B4, on every rank


def test_one_rank_in_process_is_bitwise_solve_batch(lqr_batch, no_group):
    _, z0_np, bc_np = lqr_batch
    system, _ = build_lqr(port_lobatto, 6, 6)
    c = system.compiled
    opts = default_options(torch.float64)
    z0 = torch.as_tensor(z0_np, dtype=torch.float64)
    bc = torch.as_tensor(bc_np, dtype=torch.float64)
    want = ipm.solve_batch(system, z0, bc_overrides=(bc,), optimizer_options=opts)

    mesh = instance_mesh(device_type="cpu")  # makes the one-rank gloo group
    assert tuple(mesh.mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("dp", "ep")
    assert dist.get_backend() == "gloo"
    assert local_rows(B, mesh) == slice(0, B)
    bounds0 = Bounds(*(torch.as_tensor(np.asarray(b, dtype=np.float64))
                       for b in (c.z_lb, c.z_ub, c.c_lb, c.c_ub)))
    got, n_conv = make_sharded_batch_solver(c, mesh, opts)(
        z0, broadcast_bounds(bounds0, B), {"bc": (bc,)}
    )
    for name in ("z", "obj", "status", "iterations", "y"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(n_conv) == int((want.status == 0).sum()) == B
    with pytest.raises(ValueError, match="divisible"):
        instance_mesh(ep_size=2, device_type="cpu")


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(kw)


_LAUNCH_VARS = ("WORLD_SIZE", "MASTER_ADDR", "RANK", "SLURM_JOB_ID", "SLURM_PROCID",
                "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")


@pytest.mark.parametrize("case", ["explicit", "file_store", "torchrun", "slurm", "openmpi",
                                  "plain_host", "one_process"])
def test_initialize_distributed_cases(case, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(port_dist.dist, "init_process_group", rec)
    monkeypatch.setattr(port_dist.dist, "is_initialized", lambda: False)
    for var in _LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    env, args, want = {
        # A1: exactly the caller's values
        "explicit": ({}, ("10.0.0.1:1234", 4, 2),
                     dict(backend=None, init_method="tcp://10.0.0.1:1234", world_size=4, rank=2)),
        "file_store": ({}, ("file:///tmp/s", 2, 1),
                       dict(backend=None, init_method="file:///tmp/s", world_size=2, rank=1)),
        # A2: scheduled launches through env://
        "torchrun": ({"WORLD_SIZE": "8", "MASTER_ADDR": "h", "RANK": "3"}, (),
                     dict(backend=None, init_method="env://", world_size=8, rank=3)),
        "slurm": ({"SLURM_JOB_ID": "7", "SLURM_PROCID": "1", "SLURM_NTASKS": "4"}, (),
                  dict(backend=None, init_method="env://", world_size=4, rank=1)),
        "openmpi": ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "0"}, (),
                    dict(backend=None, init_method="env://", world_size=2, rank=0)),
        # A3 and the num_processes <= 1 rule: no-ops
        "plain_host": ({}, (), None),
        "one_process": ({"WORLD_SIZE": "8", "MASTER_ADDR": "h"}, (None, 1, 0), None),
    }[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert initialize_distributed(*args) is (want is not None)
    assert rec.calls == ([want] if want is not None else [])


def test_replicate_for_batch():
    tree = {"a": torch.ones(3), "b": (torch.zeros(2, 2),), "c": np.arange(4.0)}
    out = replicate_for_batch(tree, 5)
    assert out["a"].shape == (5, 3)
    assert out["b"][0].shape == (5, 2, 2)
    assert out["c"].shape == (5, 4) and (out["c"][3] == np.arange(4.0)).all()
    bounds = replicate_for_batch(Bounds(*(torch.zeros(2) for _ in range(4))), 3)
    assert isinstance(bounds, Bounds) and bounds.z_lb.shape == (3, 2)
