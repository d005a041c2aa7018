"""The trace reader on a small Chrome trace made here."""

import json

import pytest

from benchmark import trace


def _ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "args": args}


def test_trace_reader(tmp_path):
    events = [
        _ev("ipm.iteration", "user_annotation", 0, 500),
        _ev("aten::mm", "cpu_op", 10, 50),
        _ev("cudaLaunchKernel", "cuda_runtime", 20, 5),
        _ev("ipm.iteration", "user_annotation", 600, 300),
        _ev("aten::index", "cpu_op", 610, 200),
        _ev("cudaStreamSynchronize", "cuda_runtime", 850, 40),
        _ev("void factor_kernel<float, 16>(...)", "kernel", 100, 100, grid=[2048, 1, 1]),
        _ev("gemm", "kernel", 150, 100),  # overlaps the factor: 100..250 busy
        _ev("void apply_down_kernel<float, 16>(...)", "kernel", 300, 20),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 700, 10, bytes=196608),
        _ev("Memset (Device)", "gpu_memset", 860, 4),
        _ev("ipm.iteration", "gpu_user_annotation", 100, 800),  # not device work
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.read(str(path))
    assert s["trips"] == 2
    assert s["busy_s"] == pytest.approx((150 + 20 + 10 + 4) / 1e6)
    assert [e["dur_s"] for e in s["port"]["factor"]] == [pytest.approx(100e-6)]
    assert len(s["port"]["apply_down"]) == 1 and not s["port"]["apply_up"]
    # gaps, longest first: 320..700 (only the first trip open), 710..860
    # (aten::index, the event open there that began last), 250..300
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([380e-6, 150e-6, 50e-6])
    assert [g[0] for g in s["idle_gaps"]] == ["ipm.iteration", "aten::index", "ipm.iteration"]
    assert s["device_ops"][0][0].startswith("void factor_kernel")
