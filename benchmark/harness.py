"""The benchmark's harness: one run of one cell, driven by the files that
``BENCHMARK.json`` names.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
harness loads, by name alone:

- ``configs/<config>.json`` (the configuration as run) and
  ``configs/<config>.py`` (its build through the port's frontend);
- ``traffic/<mix>.json``, read by the one generator, ``traffic.py``, and
  ``kinds/<kind>.py``, which makes the calls of the mix's ``kind``;
- ``end_to_end/<metric>.py`` for each end-to-end metric and
  ``per_layer/<metric>.py`` for each per-layer metric, ``<metric>`` being
  the part of its name before the first ``.``;
- ``reference/<config>.py``, the configuration's plain reference.

A run: set-up (build the problem, warm every shape the mix uses), then the
window (calls back to back for ``seconds``, each timed on the host and
ending in a synchronisation), then, with ``trace``, one more call on the
inputs of the window's last, once unprofiled and once under
``torch.profiler``; then the judgement of every answer of the window (or a
sample drawn from the seed) against the plain reference, once the
program's state is freed.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark import trace as trace_mod
from benchmark import traffic

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pockit_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every metric of this
    benchmark but ``setup_s`` lists its cells under ``workloads``."""
    return cell in metric.get("workloads", [cell])


def reader(group: str, name: str):
    """``benchmark/<group>/<metric>.py`` of the metric ``name``."""
    return importlib.import_module(f"benchmark.{group}.{name.split('.')[0]}")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    cfg: dict
    mix: dict
    kind: object  # kinds/<mix kind>.py
    port: object  # configs/<config>.py
    reference: object  # reference/<config>.py
    end_to_end: list
    per_layer: list
    readers: dict  # metric name -> its reader module, end-to-end and per-layer


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or load_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    end_to_end = [m for m in spec["end_to_end"] if applies(m, name)]
    per_layer = [m for m in spec["per_layer"] if applies(m, name)]
    mix = traffic.load(wl["traffic"])
    return Cell(
        name=name, workload=wl,
        cfg=json.loads((ROOT / conf["file"]).read_text()),
        mix=mix,
        kind=importlib.import_module(f"benchmark.kinds.{mix['kind']}"),
        port=importlib.import_module(f"benchmark.configs.{wl['config']}"),
        reference=importlib.import_module(f"benchmark.reference.{wl['config']}"),
        end_to_end=end_to_end,
        per_layer=per_layer,
        readers={**{m["name"]: reader("end_to_end", m["name"]) for m in end_to_end},
                 **{m["name"]: reader("per_layer", m["name"]) for m in per_layer}},
    )


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class CellRun:
    """The calls of one run, made by the mix's kind (``kinds/<kind>.py``):
    ``setup()``, then ``call()`` per window step, each timed on the host up
    to a synchronisation and returning its record; ``repeat(rec)`` runs the
    call that made ``rec`` again on the same inputs. ``control`` runs the
    mix's control (its lower-precision path) in the program's place."""

    def __init__(self, cell: Cell, seed: int, device="cuda", batch=None, control=False,
                 problem=None):
        import torch

        mix = cell.mix
        self.cell, self.mix, self.device = cell, mix, device
        self.B = int(batch or mix["batch"])
        self.control = mix.get("control", {}) if control else {}
        self.dtype = getattr(torch, self.control.get("dtype", mix["dtype"]))
        self.stream = traffic.Stream(mix, seed, self.B)
        self.problem = problem or cell.port.build(cell.cfg)
        self.system = self.problem.system
        self.state = {}

    def ip_options(self, key="options"):
        """The mix's solver options under ``key``, with the control's."""
        from pockit_tpu_torch.solver import IPOptions

        return IPOptions(**{**self.mix[key], **self.control.get("options", {})})

    def tensor(self, a):
        import torch

        return torch.as_tensor(a, device=self.device, dtype=self.dtype)

    def bc(self, params):
        return tuple(self.tensor(v) for v in self.cell.port.boundary(self.problem, params))

    def guess(self):
        g = self.problem.guesses[self.mix["guess"]]
        return self.tensor(np.tile(g, (self.B, 1)))

    def setup(self):
        self.cell.kind.setup(self)
        _sync(self.device)

    def _timed(self, make, params):
        t0 = time.perf_counter()
        rec = make()
        _sync(self.device)
        return {**rec, "params": params, "wall_s": time.perf_counter() - t0}

    def call(self, params=None):
        params = self.stream.next() if params is None else params
        return self._timed(lambda: self.cell.kind.call(self, params), params)

    def repeat(self, rec):
        return self._timed(lambda: self.cell.kind.repeat(self, rec), rec["params"])

    def window(self, seconds: float):
        """Calls back to back from now until ``seconds`` have passed; every
        call started in the window runs to its end. Returns (records,
        seconds from the window's start to the end of the last call)."""
        recs = []
        t0 = time.perf_counter()
        while not recs or time.perf_counter() - t0 < seconds:
            recs.append(self.call())
        return recs, time.perf_counter() - t0


def host_arrays(recs: list) -> list:
    """The window's answers on the host: per call ``params``, ``status``,
    ``obj``, ``iterations``, ``first_pass`` (numpy) and ``z`` (the device
    tensor, still the program's)."""
    out = []
    for r in recs:
        h = lambda a: a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
        out.append({"params": r["params"], "status": h(r["status"]).astype(np.int64),
                    "obj": h(r["obj"]).astype(np.float64),
                    "iterations": h(r["iterations"]).astype(np.int64),
                    "first_pass": None if r.get("first_pass") is None else h(r["first_pass"]),
                    "z": r["z"], "wall_s": r["wall_s"]})
    return out


def _gaps(prog: dict, ref: dict, compared=None) -> tuple:
    """The objective's and the solution's largest gaps, each absolute
    difference over the reference's largest magnitude among these lanes
    (a lane's own objective can be all but 0: the LQR's is J1 x0^2); the
    solution's over the ``compared`` parts (all where ``None``); and every
    part's gap."""
    obj = _worst(*np.abs(prog["obj"] - ref["obj"])) / max(_worst(*np.abs(ref["obj"])), 1e-300)
    parts = {}
    for k, r in ref.items():
        if k in ("obj", "kkt_norm"):
            continue
        scale = max(float(np.max(np.abs(r))), 1e-300)
        parts[k] = _worst(*np.abs(prog[k] - r).ravel()) / scale
    return {"obj_gap": obj, "sol_gap": max(parts[k] for k in compared or parts)}, parts


def judge(cell: Cell, drv: CellRun, answers: list, seed: int, converged_only=False) -> dict:
    """Compare the window's answers with the plain reference.

    ``judge.lanes`` ``"all"``: every lane of every call, a call at a time
    (the reference of such a configuration runs on the host). A number:
    that many (call, lane) pairs drawn from the seed, with the lane that
    took the most iterations; their answers are decoded to the host and the
    program's state freed before the reference runs. ``judge.feasibility``
    ``"all"``: besides, every lane's constraint residual in the reference's
    own transcription. ``converged_only`` leaves out the lanes whose
    status is not converged (a reading of the control, never a run's)."""
    import torch

    spec = cell.mix["judge"]
    decode = lambda z: cell.port.decode(drv.problem, z)
    checks = {"obj_gap": 0.0, "sol_gap": 0.0}
    parts = {}
    ref_norm = 0.0
    n = 0

    def compare(params, obj, dec):
        nonlocal checks, ref_norm
        ref = cell.reference.solve(cell.cfg, params, device=drv.device,
                                   **spec.get("reference", {}))
        g, by_part = _gaps({"obj": obj, **dec}, ref, spec.get("parts"))
        checks = {k: _worst(checks[k], g[k]) for k in checks}
        for k, v in by_part.items():
            parts[k] = _worst(parts.get(k, 0.0), v)
        if "kkt_norm" in ref:
            ref_norm = _worst(ref_norm, *ref["kkt_norm"])
        return len(obj)

    if spec["lanes"] == "all":
        for a in answers:
            dec = decode(a["z"])
            a["z"] = None
            keep = a["status"] == 0 if converged_only else np.ones(len(a["obj"]), bool)
            if keep.any():
                n += compare({k: v[keep] for k, v in a["params"].items()}, a["obj"][keep],
                             {k: v[keep] for k, v in dec.items()})
        return {"checks": checks, "judged_lanes": n, "reference_kkt_norm": ref_norm,
                "part_gaps": parts}

    rng = np.random.default_rng([seed, 7])
    count = int(spec["lanes"])
    pairs = {(int(c), int(l)) for c, l in zip(rng.integers(0, len(answers), count),
                                              rng.integers(0, drv.B, count))}
    c = int(np.argmax([a["iterations"].max() for a in answers]))
    pairs.add((c, int(np.argmax(answers[c]["iterations"]))))
    pairs = sorted((c, l) for c, l in pairs
                   if not converged_only or answers[c]["status"][l] == 0)
    params = {k: np.array([answers[c]["params"][k][l] for c, l in pairs])
              for k in answers[0]["params"]}
    obj = np.array([answers[c]["obj"][l] for c, l in pairs])
    rows = [decode(answers[c]["z"][l : l + 1]) for c, l in pairs]
    dec = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    feas_in = []
    if spec.get("feasibility") == "all":
        feas_in = [(a["params"], decode(a["z"])) for a in answers]
    for a in answers:
        a["z"] = None
    drv.state.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    n = compare(params, obj, dec)
    if feas_in:
        checks["feas"] = _worst(*(_worst(*cell.reference.feasibility(cell.cfg, p, d, device=drv.device))
                                  for p, d in feas_in))
    return {"checks": checks, "judged_lanes": n, "reference_kkt_norm": ref_norm,
            "part_gaps": parts}


def _worst(*values) -> float:
    """The largest of ``values``, NaN where any is NaN (``max`` drops it)."""
    return float(np.max(np.asarray(values, dtype=np.float64)))


def verdict(checks: dict, limits: dict, ref_norm: float) -> tuple:
    """``(correct, [(name, value, limit)])``: every number within its limit
    (a missing limit fails), and the reference itself converged."""
    rows = [(k, v, limits.get(k)) for k, v in checks.items()]
    ok = all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and ref_norm <= 1e-9, rows


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def layer_context(cell, drv, answers, last, trace_summary) -> dict:
    """What the per-layer readers read: the configuration, the type, every
    lane's iterations and first-pass flags over the window, the repeated
    call (``last``: its unprofiled wall, ``lanes``) and its trace."""
    return {
        "cfg": cell.cfg, "dtype": str(drv.dtype).split(".")[-1],
        "window": {
            "iterations": np.concatenate([a["iterations"] for a in answers]),
            "first_pass": (np.concatenate([a["first_pass"] for a in answers])
                           if answers[0]["first_pass"] is not None else None),
        },
        "last": last, "trace": trace_summary,
    }


def launch_lanes(drv, rec):
    """The lanes of every factor launch of the call ``rec``: the batch,
    where every solve of it ran on the whole batch; ``None`` where a
    drained call's first pass left lanes to the drain, whose rounds launch
    on fewer (no range marks them yet)."""
    fp = rec.get("first_pass")
    if fp is not None and not bool(fp.all()):
        return None
    return drv.B


def profiled(drv, rec):
    """The call that made ``rec`` again, unprofiled (its wall) and then
    under ``torch.profiler`` (its trace, read and deleted)."""
    from pockit_tpu_torch.utils import profile_trace

    again = drv.repeat(rec)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile_trace(tmp) as prof:
            rec2 = drv.repeat(rec)
        window_s = time.perf_counter() - t0
        summary = trace_mod.read(prof.trace_path)
    last = {"wall_s": again["wall_s"], "profiled_wall_s": window_s,
            "lanes": launch_lanes(drv, rec2)}
    return last, summary


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start=None,
             device="cuda", batch=None, control=False, spec=None, log=sys.stderr) -> dict:
    """One run of ``name`` (a cell of ``spec``, by default of
    ``BENCHMARK.json``); returns the result line's object (the last key,
    ``checks``, holds each compared number with its limit)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name, spec)
    drv = CellRun(cell, seed, device=device, batch=batch, control=control)
    drv.setup()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    recs, span_s = drv.window(seconds)
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RuntimeError(f"modules loaded in the run's process: {loaded}")

    answers = host_arrays(recs)
    last = summary = None
    if trace:
        last, summary = profiled(drv, recs[-1])
    status = np.concatenate([a["status"] for a in answers])
    walls = np.array([a["wall_s"] for a in answers])
    converged = int(np.sum(status == 0))
    metrics = {}
    if not trace:
        group = cell.end_to_end
        ctx = {"setup_s": setup_s, "span_s": span_s, "calls": len(answers), "status": status}
    else:
        group = cell.per_layer
        ctx = layer_context(cell, drv, answers, last, summary)
    for m in group:
        v = cell.readers[m["name"]].read(ctx, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    print(f"[{name}] seed {seed}: {len(answers)} calls of {drv.B} lanes in {span_s:.4f} s; "
          f"call s p10/25/50/75/90/max "
          f"{'/'.join(f'{v:.4f}' for v in np.percentile(walls, [10, 25, 50, 75, 90, 100]))}; "
          f"converged {converged}/{len(status)}; set-up {setup_s:.3f} s; "
          f"peak {peak} bytes; card {power_limit() if on_card else device}", file=log, flush=True)

    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name() if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": int(len(status)),
              "failed": int(np.sum(status != 0)), "metrics": metrics, "device": device_rec}
    if trace:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = last["profiled_wall_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        print(f"[{name}] profiled call: wall {last['wall_s']:.4f} s unprofiled, "
              f"{last['profiled_wall_s']:.4f} s profiled; busy {summary['busy_s']:.4f} s; "
              f"trips {summary['trips']}", file=log, flush=True)

    t_judge = time.perf_counter()
    j = judge(cell, drv, answers, seed)
    limits = cell.mix["limits"]
    correct, rows = verdict(j["checks"], limits, j["reference_kkt_norm"])
    result["correct"] = bool(correct)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(f"[{name}] judged {j['judged_lanes']} lanes in {time.perf_counter() - t_judge:.1f} s; "
          f"reference KKT norm "
          f"{j['reference_kkt_norm']:.3e}; solution gap by part "
          + json.dumps(j["part_gaps"]), file=log, flush=True)
    for k, v, lim in rows:
        print(f"{k} {v!r} limit {lim!r}", file=log, flush=True)
    return result


def main(args, t_start) -> int:
    import torch

    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA device for {args.workload} (needs {chips}): "
              f"available={torch.cuda.is_available()}", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except RuntimeError as e:
        print(f"[{args.workload}] {e}", file=sys.stderr)
        return 3
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"[{args.workload}] modules loaded in the run's process: {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0
