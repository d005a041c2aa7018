"""The per-span reading of a trace (``benchmark/spans.py``) on a small
Chrome trace made here, the ``factor_launches`` reader, and the split of one
call (``benchmark/split.py``) on the CPU and, marked ``gpu``, on the card,
where the program's factorization counter must equal the kernel's
launches."""

import pytest

from benchmark import harness, spans, split
from benchmark.per_layer import factor_launches


def _ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "args": args}


EVENTS = [
    _ev("ipm.init", "user_annotation", 0, 100),
    _ev("ipm.iteration", "user_annotation", 200, 400),
    _ev("ipm.assemble", "user_annotation", 200, 100),
    _ev("ipm.newton", "user_annotation", 300, 200),
    _ev("ipm.line_search", "user_annotation", 500, 50),
    _ev("ipm.update", "user_annotation", 550, 50),
    _ev("ipm.finalize", "user_annotation", 700, 100),
    _ev("ipm.iteration", "gpu_user_annotation", 220, 300),  # the device's copy: not a range
    _ev("aten::mm", "cpu_op", 305, 30),
    _ev("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
    _ev("cudaLaunchKernel", "cuda_runtime", 210, 2, correlation=2),
    _ev("cudaLaunchKernel", "cuda_runtime", 310, 2, correlation=3),
    _ev("cuLaunchKernel", "cuda_driver", 320, 2, correlation=4),
    _ev("cudaLaunchKernel", "cuda_runtime", 650, 2, correlation=5),
    _ev("cudaStreamSynchronize", "cuda_runtime", 400, 40, correlation=6),
    _ev("cudaMemcpyAsync", "cuda_runtime", 515, 2, correlation=7),
    _ev("cudaStreamSynchronize", "cuda_runtime", 520, 20, correlation=8),
    _ev("cudaDeviceSynchronize", "cuda_runtime", 710, 20, correlation=9),
    _ev("gemm", "kernel", 20, 30, correlation=1),
    _ev("void factor_kernel<double, 0>(...)", "kernel", 220, 50, correlation=2),
    _ev("elementwise", "kernel", 330, 100, correlation=3),
    _ev("reduce", "kernel", 430, 20, correlation=4),  # touches the last: one busy stretch
    _ev("fill", "kernel", 660, 10, correlation=5),
    _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 720, 5, correlation=7),
]


def test_spans_attribute_launches_syncs_and_idle_to_the_innermost_range():
    s = spans.summarize_spans(EVENTS)
    sp = s["spans"]
    assert {k: v["calls"] for k, v in sp.items() if v["calls"]} == {
        "ipm.init": 1, "ipm.iteration": 1, "ipm.assemble": 1, "ipm.newton": 1,
        "ipm.line_search": 1, "ipm.update": 1, "ipm.finalize": 1}
    assert {k: v["kernels"] for k, v in sp.items() if v["kernels"]} == {
        "ipm.init": 1, "ipm.assemble": 1, "ipm.newton": 2, spans.OUTSIDE: 1}
    assert sp["ipm.newton"]["kernel_s"] == pytest.approx(120e-6)
    assert {k: v["syncs"] for k, v in sp.items() if v["syncs"]} == {
        "ipm.newton": 1, "ipm.line_search": 1, "ipm.finalize": 1}
    assert s["launches_in_trips"] == 3 and s["syncs_in_trips"] == 2
    # gaps 50..220 (under init), 270..330 (assemble), 450..660 (newton),
    # 670..720 (between the trip and finalize)
    assert [k for k, _ in s["idle_by_span"]] == ["ipm.newton", "ipm.init", "ipm.assemble",
                                                 spans.OUTSIDE]
    assert [v for _, v in s["idle_by_span"]] == pytest.approx([210e-6, 170e-6, 60e-6, 50e-6])


def test_a_trace_with_no_range_puts_everything_outside():
    s = spans.summarize_spans([e for e in EVENTS if not e["name"].startswith("ipm.")])
    assert set(s["spans"]) == {spans.OUTSIDE}
    assert s["spans"][spans.OUTSIDE]["kernels"] == 5
    assert s["launches_in_trips"] == s["syncs_in_trips"] == 0


def test_factor_launches_reads_factor_launches_over_trips():
    tr = {"trips": 4, "port": {"factor": [{}] * 9, "apply_down": [], "apply_up": []}}
    assert factor_launches.read({"trace": tr}, "factor_launches.replan") == 2.25
    assert factor_launches.read({"trace": {**tr, "port": {"factor": []}}}, "x") is None
    assert factor_launches.read({"trace": None}, "x") is None


def test_a_traced_run_on_the_cpu_reads_no_factor_launches_and_raises_nothing():
    """The plain versions of the kernels launch nothing: the reader finds
    nothing to read, and the line leaves the metric out."""
    r = harness.run_cell("lqr_f64_mpc", 2**31 + 7, 0.3, True, device="cpu", batch=8)
    assert r["correct"] and "trip_ms.replan" in r["metrics"]
    assert "factor_launches.replan" not in r["metrics"]


def test_split_of_one_call_on_the_cpu():
    out = split.split("lqr_f64_mpc", 2**31 + 5, pairs=1, device="cpu", batch=8)
    rec = out["recorded"]["spans"]
    trips = rec["ipm.iteration"]["calls"]
    assert trips == out["trace"]["trips"] >= 1
    assert rec["ipm.init"]["calls"] == rec["ipm.finalize"]["calls"] == 1
    assert out["recorded"]["counters"]["ipm.factor_tries"] >= trips
    assert out["remainder_s"] >= 0 and out["span_off_ns"]["span"] > 0


@pytest.mark.gpu
def test_the_factor_counter_is_the_kernel_launches_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = split.split("lqr_f64_mpc", 2**31 + 6, pairs=1, batch=1024)
    tries = out["recorded"]["counters"]["ipm.factor_tries"]
    assert tries == out["recorded_launches"]["factor"] == out["trace"]["factor_launches"]
    assert out["trace"]["launches_in_trips"] > 0
