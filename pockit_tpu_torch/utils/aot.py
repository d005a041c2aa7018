"""Ahead-of-time solver artifacts (``torch.export``).

The port of ``pockit_tpu/utils/aot.py``. A cold start of the port pays the
SymPy frontend (building the ``System``, lowering its expressions, the
block-arrow layout and the assembly's host tables) before the first
solve. An artifact holds what the solver needs instead, so a serving
process loads it and solves with no ``System`` built and no module of the
frontend (``base``, ``lobatto``, ``radau``, ``transcription``) imported:

- ``torch.export`` programs of the per-lane NLP callbacks
  (``objective_fn``, ``constraints_fn``) and of the per-lane block-arrow
  assembly (``BlockKKT.assemble``), which the loader hands to
  :func:`~pockit_tpu_torch.solver.make_ip_solver` as the live path hands
  it the Python callables; the solver batches and differentiates them
  with ``torch.func`` exactly as it does those. The kernels come from the
  usual build directory;
- the bounds, the default boundary values, the block-arrow layout, the
  options and what the artifact is pinned to.

The JAX package's artifact is one traced StableHLO program of the whole
solve. The port is eager, so its artifact carries the traced functions
and the loader rebuilds the solver loop around them.

An artifact is pinned to the batch size, the dtype and the platform
(``cuda`` or ``cpu``, where it was exported): a call with another batch
size, or with a tensor of another dtype or on another platform, raises
``ValueError``. It is also pinned to ``L``, ``m`` and the layout, the
options, the torch version and the hash of the kernel source; loading one
exported under another torch or kernel source raises ``ValueError``, so
:func:`artifact_name` stamps both platform and torch version into the
file name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

from pockit_tpu_torch.optimizer.ipm import default_options, kkt_parts, make_drain_round, solver_cache
from pockit_tpu_torch.solver import Bounds, IPOptions, broadcast_bounds, make_ip_solver
from pockit_tpu_torch.solver._build import source_hash
from pockit_tpu_torch.solver.structured import StructuredLayout

FORMAT = "pockit_tpu_torch.aot/1"
_PROGRAMS = ("objective", "constraints", "assemble")


class _Fn(torch.nn.Module):
    """A callable as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args) -> bytes:
    """Trace ``fn`` at ``args`` into one ATen graph and serialize it.

    ``make_fx`` traces through the ``torch.func`` transforms inside the
    block assembly (``torch.export`` alone refuses them); dead-code
    elimination then drops functorch's shape probes, whose constants hold
    no storage, before ``torch.export`` makes the graph a program."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda *a: fn(*a))(*args)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    used = {n.target for n in gm.graph.nodes if n.op == "get_attr"}
    for name in [k for k in gm._buffers if k not in used]:
        del gm._buffers[name]
    buf = io.BytesIO()
    torch.export.save(torch.export.export(_Fn(gm), tuple(args)), buf)
    return buf.getvalue()


def _pins(device, dtype) -> dict:
    device = torch.device(device)
    return {
        "platform": device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": str(dtype).removeprefix("torch."),
        "torch": torch.__version__,
        "kernel_source": source_hash(),
    }


def _export_artifact(system, kind, batch_size, drain_size, optimizer_options, device, dtype):
    dtype = dtype or torch.get_default_dtype()
    options = optimizer_options or default_options(dtype)
    compiled = system.compiled
    L, m = int(compiled.L), int(compiled.m)
    rt = compiled.default_runtime(device, dtype)
    # the programs depend on the KKT path, device and dtype, not on the
    # batch or the kind: the artifacts of one system share one trace
    traced = getattr(compiled, "_aot_programs", None)
    if traced is None:
        traced = compiled._aot_programs = {}
    key = (options.kkt_solver, str(torch.device(device)), dtype)
    if key not in traced:
        structured, block = kkt_parts(system, options)
        z = torch.zeros(L, dtype=dtype, device=device)
        y = torch.zeros(m, dtype=dtype, device=device)
        programs = {"objective": _export(compiled.objective_fn, (z, rt))}
        if m:
            programs["constraints"] = _export(compiled.constraints_fn, (z, rt))
        if block is not None:
            programs["assemble"] = _export(block.assemble, (z, y, y + 1, rt))
        traced[key] = (programs, structured if block is None else block.layout, block is not None)
    programs, layout, on_block = traced[key]
    meta = {
        "format": FORMAT,
        "kind": kind,
        "batch_size": int(batch_size),
        "drain_size": drain_size,
        "L": L,
        "m": m,
        "n_fixed": [int(v.shape[0]) for v in rt["bc"]],
        "layout": None if layout is None else {
            "path": "block" if on_block else "structured",
            "krylov_rank": int(layout.krylov_rank),
            "n_cols": int(layout.n_cols),
        },
        "options": dataclasses.asdict(options),
        **_pins(device, dtype),
    }
    arrays = {
        name: np.asarray(v, dtype=np.float64)
        for name, v in zip(Bounds._fields, (compiled.z_lb, compiled.z_ub, compiled.c_lb, compiled.c_ub))
    }
    arrays.update({f"bc{i}": v.cpu().double().numpy() for i, v in enumerate(rt["bc"])})
    if layout is not None:
        arrays["interior"] = np.asarray(layout.interior, dtype=np.int64)
        arrays["reduced"] = np.asarray(layout.reduced, dtype=np.int64)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        zf.writestr("meta.json", json.dumps(meta, sort_keys=True))
        npz = io.BytesIO()
        np.savez(npz, **arrays)
        zf.writestr("arrays.npz", npz.getvalue())
        for name, blob in programs.items():
            zf.writestr(f"{name}.pt2", blob)
    return out.getvalue()


def export_batch_solver(
    system,
    batch_size: int,
    optimizer_options: Optional[IPOptions] = None,
    *,
    device="cuda",
    dtype=None,
) -> bytes:
    """Trace the solver's functions once and serialize them as a batch
    artifact for ``device`` (the card unless ``device="cpu"``) and
    ``dtype`` (default ``torch.get_default_dtype()``).

    The loaded artifact's calling convention is ``(guess_batch, *bc_batches)
    -> IPResult`` with ``guess_batch (B, L)`` and one ``(B, n_fixed)`` array
    per phase (the FIXED boundary values, the per-instance data of a
    sweep). Bounds are baked in from the system configuration.
    """
    return _export_artifact(system, "batch", batch_size, None, optimizer_options, device, dtype)


def export_drain_round(
    system,
    batch_size: int,
    drain_size: int,
    optimizer_options: Optional[IPOptions] = None,
    *,
    device="cuda",
    dtype=None,
) -> bytes:
    """Serialize one straggler-drain round of ``ipm.solve_batch_drained``.

    Calling convention: ``(z_full (B, L), idx (B_drain,), *bc_batches) ->
    (z_full', packed (3, B_drain))`` with each ``bc`` batch ``(B,
    n_fixed)``: gather the straggler rows, solve them as a compact batch,
    scatter the solutions back, all in one call; ``packed`` stacks
    (status, obj, iterations) so the host needs one fetch.
    """
    return _export_artifact(
        system, "drain_round", batch_size, int(drain_size), optimizer_options, device, dtype
    )


def save_batch_solver(path, system, batch_size, optimizer_options=None, **kw) -> None:
    """``export_batch_solver`` straight to a file."""
    blob = export_batch_solver(system, batch_size, optimizer_options, **kw)
    with open(path, "wb") as fh:
        fh.write(blob)


class _ArtifactBlock(NamedTuple):
    """What the solver reads of a ``BlockKKT``, rebuilt from an artifact."""

    layout: StructuredLayout
    interior_pad: np.ndarray
    assemble: object


class _ArtifactCompiled:
    """What ``optimizer.ipm``'s batched entry points read of a compiled
    system: sizes, bounds, default boundary values and the solver cache."""

    def __init__(self, meta, arrays):
        self.L, self.m = meta["L"], meta["m"]
        self.z_lb, self.z_ub, self.c_lb, self.c_ub = (arrays[k] for k in Bounds._fields)
        self._bc = [arrays[f"bc{i}"] for i in range(len(meta["n_fixed"]))]
        self.from_artifacts = True  # optimizer.ipm builds no solver for it
        self._ipm_cache = {}

    def default_runtime(self, device="cuda", dtype=torch.float64):
        return {"bc": tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in self._bc)}


class ArtifactSystem:
    """Stands in for the ``System`` an artifact was exported from, with no
    frontend: ``optimizer.ipm.solve_batch`` and ``solve_batch_drained`` on
    it run the artifacts installed on it (and raise for options with
    none)."""

    def __init__(self, meta, arrays):
        self.compiled = _ArtifactCompiled(meta, arrays)


def _check_pins(meta):
    if meta["torch"] != torch.__version__:
        raise ValueError(f"artifact exported under torch {meta['torch']}, this is {torch.__version__}")
    if meta["kernel_source"] != source_hash():
        raise ValueError("artifact exported against another kernel source")
    if meta["platform"] == "cuda" and not torch.cuda.is_available():
        raise ValueError("artifact exported for the CUDA card; there is none here")


def _open(path_or_bytes):
    """``(meta, zip)`` of an artifact whose pins hold here."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            blob = fh.read()
    zf = zipfile.ZipFile(io.BytesIO(blob))
    meta = json.loads(zf.read("meta.json"))
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact")
    _check_pins(meta)
    return meta, zf


def load_batch_solver(path_or_bytes):
    """Load an artifact of :func:`export_batch_solver` (returns ``call(z0,
    *bc) -> IPResult``) or of :func:`export_drain_round` (returns
    ``call(z_full, idx, *bc) -> (z_full', packed)``).

    Nothing is traced and no frontend is imported: the solver is rebuilt
    around the artifact's programs. ``call`` takes numpy arrays, which it
    places on the artifact's platform and dtype, or tensors already there;
    a tensor on another platform or of another dtype raises ``ValueError``.
    Loads share the programs of equal bytes (``_LOADED``). ``call.meta``
    is the artifact's metadata, ``call.options`` its options,
    ``call.programs`` its loaded programs, ``call.system`` an
    :class:`ArtifactSystem` to install it on, and ``call.kkt_path`` the
    solver's.
    """
    return _load(*_open(path_or_bytes))


# loaded programs by the hash of their bytes: the artifacts of one system
# (a first pass and its drain round) carry the same programs, loaded once
_LOADED: dict = {}


def _program(blob: bytes):
    key = hashlib.sha256(blob).hexdigest()
    if key not in _LOADED:
        _LOADED[key] = torch.export.load(io.BytesIO(blob)).module()
    return _LOADED[key]


def _load(meta, zf):
    arrays = dict(np.load(io.BytesIO(zf.read("arrays.npz"))))
    programs = {
        name: _program(zf.read(f"{name}.pt2"))
        for name in _PROGRAMS
        if f"{name}.pt2" in zf.namelist()
    }
    options = IPOptions(**meta["options"])
    device = torch.device(meta["platform"])
    dtype = getattr(torch, meta["dtype"])
    L, m = meta["L"], meta["m"]
    layout = block = structured = None
    if meta["layout"] is not None:
        layout = StructuredLayout(
            arrays["interior"], arrays["reduced"], meta["layout"]["krylov_rank"],
            meta["layout"]["n_cols"],
        )
        if meta["layout"]["path"] == "block":
            block = _ArtifactBlock(layout, arrays["interior"], programs["assemble"])
        else:
            structured = layout
    solve_fn = make_ip_solver(
        programs["objective"], programs.get("constraints"), L, m, options,
        structured=structured, block=block,
    )
    bounds0 = Bounds(*(torch.as_tensor(arrays[k], dtype=dtype, device=device) for k in Bounds._fields))
    B = meta["batch_size"]

    def t(a, what, want=dtype):
        """An input on the artifact's platform and dtype: a numpy array is
        placed there; a tensor must already be there, since the artifact
        is pinned to both."""
        if not isinstance(a, torch.Tensor):
            return torch.as_tensor(a, dtype=want, device=device)
        if a.device.type != device.type or a.dtype != want:
            raise ValueError(
                f"{what}: a {str(a.dtype).removeprefix('torch.')} tensor on {a.device.type}, "
                f"artifact pinned to {str(want).removeprefix('torch.')} on {device.type}"
            )
        return a

    def _bc(bc, rows):
        bc = tuple(t(v, "boundary values") for v in bc)
        want = [(rows, n) for n in meta["n_fixed"]]
        if [tuple(v.shape) for v in bc] != want:
            raise ValueError(f"boundary values of shapes {[tuple(v.shape) for v in bc]}, artifact pinned to {want}")
        return bc

    if meta["kind"] == "batch":
        bounds_b = broadcast_bounds(bounds0, B)

        def call(z0, *bc):
            z0 = t(z0, "guess batch")
            if tuple(z0.shape) != (B, L):
                raise ValueError(f"guess batch of shape {tuple(z0.shape)}, artifact pinned to {(B, L)}")
            return solve_fn(z0, bounds_b, {"bc": _bc(bc, B)})

    else:
        Bd = meta["drain_size"]
        drain_round = make_drain_round(solve_fn, broadcast_bounds(bounds0, Bd))

        def call(z_full, idx, *bc):
            z_full = t(z_full, "z_full")
            idx = t(idx, "idx", torch.int64)
            if tuple(z_full.shape) != (B, L) or tuple(idx.shape) != (Bd,):
                raise ValueError(
                    f"z_full {tuple(z_full.shape)} and idx {tuple(idx.shape)}, artifact "
                    f"pinned to {(B, L)} and {(Bd,)}"
                )
            return drain_round(z_full, idx, *_bc(bc, B))

    call.meta = meta
    call.options = options
    call.programs = programs
    call.system = ArtifactSystem(meta, arrays)
    call.kkt_path = solve_fn.kkt_path
    return call


def artifact_name(tag: str, batch_size: int, *, device="cuda", dtype=None) -> str:
    """Canonical artifact file name: pins the platform, the precision and
    the torch version, so a stale artifact is a clean miss, not an error."""
    dtype = dtype or torch.get_default_dtype()
    prec = "f64" if dtype == torch.float64 else "f32"
    return f"{tag}_B{batch_size}_{torch.device(device).type}_{prec}_torch{torch.__version__}.aot.zip"


def _install(system, optimizer_options, path_or_bytes, kind):
    meta, zf = _open(path_or_bytes)
    if meta["kind"] != kind:
        raise ValueError(f"a {meta['kind']} artifact, not a {kind} one")
    exported = IPOptions(**meta["options"])
    options = optimizer_options or exported
    if options != exported:
        raise ValueError(f"artifact exported with {exported}, not {options}")
    if system is not None and (int(system.compiled.L), int(system.compiled.m)) != (meta["L"], meta["m"]):
        raise ValueError(
            f"artifact of L={meta['L']}, m={meta['m']} for a system of "
            f"L={system.compiled.L}, m={system.compiled.m}"
        )
    call = _load(meta, zf)
    target = call.system if system is None else system
    solver_cache(target.compiled)[(options, kind)] = call
    return target


def install_batch_solver(system, optimizer_options, path_or_bytes):
    """Install a :func:`export_batch_solver` artifact, so that
    ``ipm.solve_batch`` (and so ``solve_batch_drained``'s first pass) with
    ``optimizer_options`` runs it instead of building a solver.

    ``system`` is the live ``System`` or an :class:`ArtifactSystem`;
    ``None`` installs on the artifact's own :class:`ArtifactSystem`, which
    needs no frontend. ``optimizer_options`` must be the artifact's
    (``None`` takes them). Bounds were baked in at export. Returns the
    system it installed on.
    """
    return _install(system, optimizer_options, path_or_bytes, "batch")


def install_drain_round(system, optimizer_options, path_or_bytes):
    """Install a :func:`export_drain_round` artifact, so that every drain
    round of ``ipm.solve_batch_drained`` with ``optimizer_options`` runs
    it (same rules as :func:`install_batch_solver`)."""
    return _install(system, optimizer_options, path_or_bytes, "drain_round")
