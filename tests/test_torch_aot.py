"""The port's solver artifacts on the CPU: the three cases of the JAX
package's ``tests/test_parallel/test_aot.py`` (round trip, wrong batch,
install) on its LQR 6x7 in float64, and a fresh process that loads an
artifact and solves with no module of the frontend imported.

Tolerances: the artifact against the live solve, obj rtol 1e-12 and z
atol 1e-10 (the JAX test's); the same bytes loaded twice (the second load
deserialized anew), bit for bit; the installed drained solve against the
live one, equal statuses, obj rtol 1e-10 and z atol 1e-9 (the JAX
test's). The artifact's programs are traced from the live functions, and
the assembly and callbacks evaluate bit for bit as the live ones do, so
these hold with room. Against the JAX package's solves of the same batch
(its ``solve_batch`` for the round trip, its ``solve_batch_drained`` for
the installed artifacts): equal statuses, obj rtol 1e-8 (the port's
cross-package LQR tolerance) and z atol 1e-9 (the two packages' float64
solves of this batch differ by about 3e-12 in z).
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as lobatto
from pockit_tpu.optimizer import ipm as ref_ipm
from pockit_tpu.solver import IPOptions as RefOptions
from pockit_tpu_torch.optimizer import ipm
from pockit_tpu_torch.optimizer._common import preprocess
from pockit_tpu_torch.solver import IPOptions
from pockit_tpu_torch.utils import aot, load_batch_solver, save_batch_solver

from test_torch_sharding import ROOT

B, BD = 8, 4
OPTS = IPOptions(tol=1e-9)
OPTS_FAST = IPOptions(tol=1e-9, max_iter=3)  # guarantees stragglers
OPTS_DRAIN = IPOptions(tol=1e-9, max_iter=60)
F64 = dict(device="cpu", dtype=torch.float64)


def _lqr(mesh, lobatto=lobatto):
    """The JAX test's LQR on ``mesh`` intervals of 7 points, built with
    either package's ``lobatto``."""
    system = lobatto.System(["x_f"])
    (x_f,) = system.s
    phase = system.new_phase(["x"], ["u"])
    (x,) = phase.x
    (u,) = phase.u
    phase.set_dynamics([-x + u])
    phase.set_integral([x**2 + 0.1 * u**2])
    phase.set_boundary_condition([1], [x_f], 0, 1)
    phase.set_discretization(mesh, 7)
    system.set_phase([phase])
    system.set_objective(phase.I[0] + x_f**2 / 2)
    return system, phase


@pytest.fixture(scope="module")
def lqr():
    system, phase = _lqr(6)
    x0, _ = preprocess(system, [lobatto.constant_guess(phase, 0), [0.0]])
    bc = np.tile(np.asarray(system.compiled.phases[0].fixed_vals), (B, 1))
    bc[:, 0] = np.random.default_rng(0).uniform(0.5, 1.5, B)
    return system, np.tile(x0, (B, 1)), bc


def _ref(options):
    return RefOptions(**dataclasses.asdict(options))


def _assert_matches_reference(status, obj, z, want):
    """The port's result against the JAX package's ``(status, obj, z)``."""
    np.testing.assert_array_equal(np.asarray(status), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(obj), np.asarray(want[1]), rtol=1e-8, atol=0)
    np.testing.assert_allclose(np.asarray(z), np.asarray(want[2]), rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def reference(lqr):
    """The JAX package's solves of the same batch: ``solve_batch`` and
    ``solve_batch_drained``, each ``(status, obj, z)``."""
    _, z0, bc = lqr
    ref_sys, _ = _lqr(6, ref_lobatto)
    res = ref_ipm.solve_batch(ref_sys, z0, bc_overrides=(bc,), optimizer_options=_ref(OPTS))
    st, obj, _, z = ref_ipm.solve_batch_drained(
        ref_sys, z0, bc_overrides=(bc,), optimizer_options=_ref(OPTS_DRAIN),
        first_pass_options=_ref(OPTS_FAST), drain_frac=B // BD)
    return {"batch": (res.status, res.obj, res.z), "drained": (st, obj, z)}


@pytest.fixture(scope="module")
def batch_artifact(lqr, tmp_path_factory):
    system, _, _ = lqr
    path = tmp_path_factory.mktemp("aot") / aot.artifact_name("lqr_roundtrip", B, **F64)
    save_batch_solver(path, system, B, OPTS, **F64)
    return path, load_batch_solver(path)


def test_aot_roundtrip_matches_live_solve(lqr, batch_artifact, reference):
    (system, z0, bc), (path, call) = lqr, batch_artifact
    assert path.stat().st_size > 0
    res_aot = call(z0, bc)
    res_live = ipm.solve_batch(system, z0, bc_overrides=(bc,), optimizer_options=OPTS, **F64)
    assert bool((res_aot.status == 0).all())
    np.testing.assert_allclose(res_aot.obj.numpy(), res_live.obj.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(res_aot.z.numpy(), res_live.z.numpy(), rtol=0, atol=1e-10)
    _assert_matches_reference(res_aot.status, res_aot.obj, res_aot.z, reference["batch"])
    # bytes round-trip without touching disk: the same artifact, bit for
    # bit; with the loaded programs dropped, the second load deserializes
    aot._LOADED.clear()
    call2 = load_batch_solver(path.read_bytes())
    assert all(call2.programs[k] is not p for k, p in call.programs.items())
    res2 = call2(z0, bc)
    assert torch.equal(res2.status, res_aot.status) and torch.equal(res2.z, res_aot.z)
    # pinned: the metadata says what to, and the name stamps platform and torch
    meta = call.meta
    assert (meta["batch_size"], meta["L"], meta["m"], meta["dtype"], meta["platform"]) == (
        B, system.compiled.L, system.compiled.m, "float64", "cpu")
    assert IPOptions(**meta["options"]) == OPTS == call.options
    assert path.name == f"lqr_roundtrip_B{B}_cpu_f64_torch{torch.__version__}.aot.zip"


def test_aot_rejects_wrong_batch_shape(lqr, batch_artifact):
    (_, z0, bc), (_, call) = lqr, batch_artifact
    with pytest.raises(ValueError, match="pinned"):
        call(z0[:4], bc[:4])  # artifact pinned to B=8
    with pytest.raises(ValueError, match="pinned"):
        call(np.concatenate([z0, z0]), np.concatenate([bc, bc]))


def test_aot_rejects_another_dtype_and_platform(lqr, batch_artifact):
    """A tensor input must already be on the artifact's platform and of its
    dtype (a numpy array is placed there): float32 tensors and tensors on
    another device (``meta`` here, the card where there is one) raise."""
    (_, z0, bc), (_, call) = lqr, batch_artifact
    z0_t, bc_t = torch.as_tensor(z0), torch.as_tensor(bc)
    with pytest.raises(ValueError, match="float32 tensor on cpu, artifact pinned to float64"):
        call(z0_t.float(), bc_t)
    with pytest.raises(ValueError, match="boundary values: a float32"):
        call(z0_t, bc_t.float())
    with pytest.raises(ValueError, match="on meta, artifact pinned to float64 on cpu"):
        call(z0_t.to("meta"), bc_t)


def test_aot_rejects_another_torch_and_kernel_source(batch_artifact, monkeypatch):
    blob = batch_artifact[0].read_bytes()
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    with pytest.raises(ValueError, match="torch"):
        load_batch_solver(blob)
    monkeypatch.undo()
    monkeypatch.setattr(aot, "source_hash", lambda *a: "another")
    with pytest.raises(ValueError, match="kernel source"):
        load_batch_solver(blob)


def _drained(system, z0, bc):
    return ipm.solve_batch_drained(
        system, z0, bc_overrides=(bc,), optimizer_options=OPTS_DRAIN,
        first_pass_options=OPTS_FAST, drain_frac=B // BD, **F64)


@pytest.fixture(scope="module")
def drained(lqr):
    """The live drained solve, and its first-pass and drain-round artifacts."""
    system, z0, bc = lqr
    live = _drained(system, z0, bc)
    assert np.all(live[0] == 0)
    first = aot.export_batch_solver(system, B, OPTS_FAST, **F64)
    drain = aot.export_drain_round(system, B, BD, OPTS_DRAIN, **F64)
    return live, first, drain


def test_install_changes_what_runs_and_matches(lqr, drained, reference, monkeypatch):
    """install_batch_solver / install_drain_round make solve_batch_drained
    run the artifacts: with every solver build refused, the drained solve
    still runs, and matches the live one and the JAX package's."""
    (system, z0, bc), ((st_ref, obj_ref, it_ref, z_ref), first, drain) = lqr, drained
    ipm.solver_cache(system.compiled).clear()  # no built solver left
    assert aot.install_batch_solver(system, OPTS_FAST, first) is system
    aot.install_drain_round(system, OPTS_DRAIN, drain)

    def refuse(*a, **k):
        raise AssertionError("a solver was built although artifacts are installed")

    monkeypatch.setattr(ipm, "_solver_for", refuse)
    st, obj, it, z = _drained(system, z0, bc)
    np.testing.assert_array_equal(st, st_ref)
    np.testing.assert_array_equal(it, it_ref)
    np.testing.assert_allclose(obj, obj_ref, rtol=1e-10, atol=0)
    np.testing.assert_allclose(z.numpy(), z_ref.numpy(), rtol=0, atol=1e-9)
    _assert_matches_reference(st, obj, z, reference["drained"])
    monkeypatch.undo()

    # installing checks what it installs
    with pytest.raises(ValueError, match="exported with"):
        aot.install_batch_solver(system, OPTS, first)
    with pytest.raises(ValueError, match="not a batch"):
        aot.install_batch_solver(system, OPTS_DRAIN, drain)
    other, _ = _lqr(5)
    with pytest.raises(ValueError, match="for a system of"):
        aot.install_batch_solver(other, OPTS_FAST, first)
    with pytest.raises(ValueError, match="installed"):  # an ArtifactSystem builds nothing
        ipm.solve_batch(aot.install_batch_solver(None, None, first), z0, bc_overrides=(bc,),
                        optimizer_options=OPTS, **F64)


_FRESH = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {root!r})
    import numpy as np
    import torch
    from pockit_tpu_torch.optimizer import ipm
    from pockit_tpu_torch.utils import aot
    inp = np.load({data!r})
    served = aot.install_batch_solver(None, None, open({first!r}, "rb").read())
    aot.install_drain_round(served, None, open({drain!r}, "rb").read())
    first = ipm.solver_cache(served.compiled)
    (fast,), (full,) = ([k[0] for k in first if k[1] == kind] for kind in ("batch", "drain_round"))
    st, obj, it, z = ipm.solve_batch_drained(
        served, inp["z0"], bc_overrides=(inp["bc"],), optimizer_options=full,
        first_pass_options=fast, drain_frac={frac}, device="cpu", dtype=torch.float64)
    frontend = sorted(m for m in sys.modules if m.split(".")[:2] in (
        ["pockit_tpu_torch", "base"], ["pockit_tpu_torch", "lobatto"],
        ["pockit_tpu_torch", "radau"], ["pockit_tpu_torch", "transcription"]))
    np.savez({out!r}, status=st, obj=obj, z=z.numpy(), frontend=np.array(frontend, dtype=str))
    """
)


def test_fresh_process_solves_from_artifacts_without_the_frontend(lqr, drained, tmp_path):
    (_, z0, bc), ((st, obj, _, z), first, drain) = lqr, drained
    paths = {"first": tmp_path / "first.aot.zip", "drain": tmp_path / "drain.aot.zip"}
    paths["first"].write_bytes(first)
    paths["drain"].write_bytes(drain)
    np.savez(tmp_path / "inputs.npz", z0=z0, bc=bc)
    script = _FRESH.format(root=ROOT, data=str(tmp_path / "inputs.npz"), out=str(tmp_path / "out.npz"),
                           first=str(paths["first"]), drain=str(paths["drain"]), frac=B // BD)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    assert got["frontend"].tolist() == []
    np.testing.assert_array_equal(got["status"], st)
    np.testing.assert_allclose(got["obj"], obj, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["z"], z.numpy(), rtol=0, atol=1e-9)
