"""The harness finds every piece by name, keeps to the contract's names and
units, and neither it nor the reference loads what it must not."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, traffic

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_piece_is_found_by_name(cell):
    c = harness.load_cell(cell)
    wl = c.workload
    assert (ROOT / "benchmark" / "configs" / f"{wl['config']}.json").exists()
    assert (ROOT / "benchmark" / "traffic" / f"{wl['traffic']}.json").exists()
    assert c.port.__name__ == f"benchmark.configs.{wl['config']}"
    assert c.reference.__name__ == f"benchmark.reference.{wl['config']}"
    assert c.kind.__name__ == f"benchmark.kinds.{c.mix['kind']}"
    for group, metrics in (("end_to_end", c.end_to_end), ("per_layer", c.per_layer)):
        for m in metrics:
            mod = c.readers[m["name"]].__name__
            assert mod == f"benchmark.{group}.{m['name'].split('.')[0]}"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert all(lim in c.mix["limits"] for lim in ("obj_gap", "sol_gap"))


def test_names_units_and_keys_keep_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        assert len({e["name"] for e in group}) == len(group)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16
    for text in ([e["why"] for e in SPEC["configs"] + SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert harness.applies(target, cell), (m["name"], cell)
        suffix = m["name"].split(".")[-1]
        assert {"sweep": "solves_per_s", "replan": "replan_ms"}[suffix] == m["moves"]


KIND = '''"""Every call a cold solve from the guess, on fresh draws."""


def setup(run):
    run.state["z0"] = run.guess()
    run.call()


def call(run, params):
    from pockit_tpu_torch.optimizer import ipm

    res = ipm.solve_batch(run.system, run.state["z0"], bc_overrides=run.bc(params),
                          optimizer_options=run.ip_options())
    return {"status": res.status, "obj": res.obj, "iterations": res.iterations, "z": res.z}


def repeat(run, rec):
    return call(run, rec["params"])
'''

CALLS_PER_S = '''def read(ctx, name):
    return ctx["calls"] / ctx["span_s"]
'''


def test_a_new_kind_mix_metric_and_cell_are_added_by_files_alone(tmp_path, monkeypatch):
    """A cell of a new kind of call, with a new mix and a new end-to-end
    metric, each a new file, runs on the CPU with no edit of the harness."""
    import benchmark.end_to_end
    import benchmark.kinds

    for group, name, text in (("kinds", "cold_once", KIND),
                              ("end_to_end", "calls_per_s", CALLS_PER_S)):
        (tmp_path / group).mkdir()
        (tmp_path / group / f"{name}.py").write_text(text)
        pkg = getattr(benchmark, group)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(tmp_path / group)])
    mix = json.loads((ROOT / "benchmark" / "traffic" / "lqr_mpc_f64.json").read_text())
    mix = {**{k: v for k, v in mix.items() if k not in ("start", "cold_start", "warm")},
           "kind": "cold_once", "draws": {"x0": {"uniform": [0.5, 1.5]}}}
    (tmp_path / "traffic").mkdir()
    for p in (ROOT / "benchmark" / "traffic").glob("*.json"):
        (tmp_path / "traffic" / p.name).write_text(p.read_text())
    (tmp_path / "traffic" / "lqr_cold_f64.json").write_text(json.dumps(mix))
    monkeypatch.setattr(traffic, "DIR", tmp_path / "traffic")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "lqr_f64_cold", "config": "lqr_lgl10x10",
                              "traffic": "lqr_cold_f64", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["lqr_f64_cold"]})
    r = harness.run_cell("lqr_f64_cold", 2**31 + 21, 0.3, False, device="cpu", batch=8,
                         spec=spec)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "calls_per_s"}
    assert r["metrics"]["calls_per_s"]["value"] > 0 and r["attempted"] % 8 == 0


def test_traffic_is_a_function_of_the_seed():
    mix = traffic.load("orbit_replan_f64")
    a, b = traffic.Stream(mix, 2**31 + 11, 64), traffic.Stream(mix, 2**31 + 11, 64)
    for _ in range(50):
        pa, pb = a.next(), b.next()
        np.testing.assert_array_equal(pa["r0"], pb["r0"])
    assert pa["r0"].min() >= 0.99 and pa["r0"].max() <= 1.03
    s = traffic.Stream(traffic.load("lqr_sweep_f32"), 7, 16384)
    x0 = s.next()["x0"]
    assert 0.5 <= x0.min() and x0.max() <= 1.5 and len(x0) == 16384


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    """Whole top-level names: ``pockit_tpu_torch`` is not ``pockit_tpu``."""
    mods = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import harness, calibrate, roofline, trace\n"
        "for w in harness.load_spec()['workloads']:\n"
        "    c = harness.load_cell(w['name']); c.port.build(c.cfg)\n"
        "import pockit_tpu_torch.optimizer.ipm, pockit_tpu_torch.utils\n")
    assert "pockit_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pockit_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.lqr_lgl10x10, benchmark.reference.orbit_radau40x10\n")
    assert not mods & {"jax", "jaxlib", "flax", "pockit_tpu", "pockit_tpu_torch"}


def test_a_nan_answer_is_not_correct():
    prog = {"obj": np.array([0.2, np.nan]), "x": np.array([[1.0, 2.0], [1.0, np.nan]])}
    ref = {"obj": np.array([0.2, 0.3]), "x": np.array([[1.0, 2.0], [1.0, 2.0]])}
    gaps, parts = harness._gaps(prog, ref)
    assert np.isnan(gaps["obj_gap"]) and np.isnan(gaps["sol_gap"]) and np.isnan(parts["x"])
    correct, _ = harness.verdict(gaps, {"obj_gap": 1.0, "sol_gap": 1.0}, 0.0)
    assert not correct


def test_gaps_are_over_the_largest_reference_magnitude():
    """An objective of nearly 0 (the LQR at x0 near 0) does not magnify its
    lane's rounding."""
    prog = {"obj": np.array([1e-8 + 1e-12, 0.5 + 1e-9])}
    ref = {"obj": np.array([1e-8, 0.5]), "x": np.zeros((2, 1))}
    gaps, _ = harness._gaps({**prog, "x": np.zeros((2, 1))}, ref)
    assert gaps["obj_gap"] == pytest.approx(2e-9)
