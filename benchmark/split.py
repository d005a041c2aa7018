"""Where one call of a cell spends its time, phase by phase: the program's
spans and counters (``pockit_tpu_torch.utils.profiling.recording``) over
one repeated call, and the kernels, synchronizations and device idle time
under each span in a profiled copy of it (``benchmark/spans.py``).

    python3 benchmark/split.py --workload <cell> --seed <n>

Set-up as a run of the cell, one call on the traffic's first draw, then
three times that call again unprofiled and again inside a recording, in
turns, then once under ``torch.profiler``. Prints one JSON object:
``walls`` (the unprofiled and the recorded repeats' seconds, the profiled
copy's), ``recorded`` (the last recording: spans and counters), the
kernel launches the recorded call made by ``cuda_kkt.LAUNCHES``, the
trace's ``trips``, factor launches, ``busy_s`` and the per-span
``spans``, ``launches_in_trips``, ``syncs_in_trips``, ``idle_by_span``;
and ``span_off_ns``, what a span and a phase mark cost with nothing
active. Not a run of the benchmark: no window, no judgement.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def off_cost_ns(n=200_000) -> dict:
    """Nanoseconds per ``with span(...)`` and per ``phases()`` block with
    four marks, with no recording and no profiler."""
    from pockit_tpu_torch.utils.profiling import phases, span

    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("ipm.iteration"):
            pass
    one = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with phases() as mark:
            mark("ipm.assemble")
            mark("ipm.newton")
            mark("ipm.line_search")
            mark("ipm.update")
    return {"span": one, "phases_of_a_trip": (time.perf_counter_ns() - t0) / n}


def split(name, seed, pairs=3, device="cuda", batch=None) -> dict:
    from benchmark import harness, spans, trace
    from pockit_tpu_torch.solver import cuda_kkt
    from pockit_tpu_torch.utils import profile_trace, recording

    cell = harness.load_cell(name)
    drv = harness.CellRun(cell, seed, device=device, batch=batch)
    drv.setup()
    rec = drv.call()
    walls = {"unprofiled_s": [], "recorded_s": []}
    for _ in range(pairs):
        walls["unprofiled_s"].append(drv.repeat(rec)["wall_s"])
        before = dict(cuda_kkt.LAUNCHES)
        with recording() as recorded:
            walls["recorded_s"].append(drv.repeat(rec)["wall_s"])
        launches = {k: v - before[k] for k, v in cuda_kkt.LAUNCHES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profile_trace(tmp) as prof:
            drv.repeat(rec)
        walls["profiled_s"] = time.perf_counter() - t0
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    summary = trace.summarize(events)
    sp = recorded["spans"]
    outer = sum(sp.get(k, {"s": 0.0})["s"] for k in ("ipm.init", "ipm.iteration", "ipm.finalize"))
    return {
        "workload": name, "seed": seed, "batch": drv.B,
        "card": harness.power_limit() if drv.device != "cpu" else "cpu",
        "walls": walls,
        "recorded_over_unprofiled": (statistics.median(walls["recorded_s"])
                                     / statistics.median(walls["unprofiled_s"])),
        "recorded": recorded,
        "remainder_s": walls["recorded_s"][-1] - outer,
        "factor_tries_per_trip": (recorded["counters"].get("ipm.factor_tries", 0)
                                  / sp["ipm.iteration"]["calls"]),
        "recorded_launches": launches,
        "trace": {"trips": summary["trips"], "factor_launches": len(summary["port"]["factor"]),
                  "busy_s": summary["busy_s"], "device_events": summary["device_events"],
                  **spans.summarize_spans(events)},
        "span_off_ns": off_cost_ns(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(split(args.workload, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
