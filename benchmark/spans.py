"""The program's phases in a ``torch.profiler`` Chrome trace: for each
``ipm.*`` range (``pockit_tpu_torch.utils.profiling.span``), the kernels
launched under it and their device seconds, the synchronizing runtime calls
made under it, and the device idle time whose gap began under it.

A kernel belongs to the innermost ``ipm.*`` range open when the host made
the runtime call that launched it (matched through the events'
``correlation``), a synchronizing call to the innermost range open when it
began, a gap between two busy intervals of the device (as in
``benchmark/trace.py``) to the innermost range open when it began. Work
under no ``ipm.*`` range goes to ``OUTSIDE``.
"""

from __future__ import annotations

import bisect

from benchmark.trace import DEVICE_CATS

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "(outside)"
TRIP = "ipm.iteration"


def _x(e, cat):
    return e.get("cat") == cat and e.get("ph") == "X" and "dur" in e


class _Ranges:
    """The ``ipm.*`` ranges of a trace (nested or disjoint, never
    overlapping otherwise), by start."""

    def __init__(self, events):
        self.r = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                        if _x(e, "user_annotation") and e["name"].startswith("ipm."))
        self.starts = [r[0] for r in self.r]
        self.trips = sorted((ts, ts - neg) for ts, neg, name in self.r if name == TRIP)
        self.trip_starts = [t[0] for t in self.trips]

    def innermost(self, t) -> str:
        """The innermost range open at ``t``: of those containing it, the
        one that began last."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            ts, neg, name = self.r[i]
            if t < ts - neg:
                return name
        return OUTSIDE

    def in_trip(self, t) -> bool:
        i = bisect.bisect_right(self.trip_starts, t) - 1
        return i >= 0 and t < self.trips[i][1]


def summarize_spans(events: list) -> dict:
    """``{"spans": {name: {"calls", "kernels", "kernel_s", "syncs",
    "idle_s"}}, "launches_in_trips", "syncs_in_trips", "idle_by_span":
    [[name, seconds], ...] longest first}``; times in seconds."""
    ranges = _Ranges(events)
    spans = {}

    def entry(name):
        return spans.setdefault(name, {"calls": 0, "kernels": 0, "kernel_s": 0.0,
                                       "syncs": 0, "idle_s": 0.0})

    for _, _, name in ranges.r:
        entry(name)["calls"] += 1
    launched_at = {}
    syncs_in_trips = 0
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or "dur" not in e:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launched_at[corr] = e["ts"]
        if e["name"] in SYNCS:
            entry(ranges.innermost(e["ts"]))["syncs"] += 1
            syncs_in_trips += ranges.in_trip(e["ts"])
    launches_in_trips = 0
    for e in events:
        if not _x(e, "kernel"):
            continue
        at = launched_at.get(e.get("args", {}).get("correlation"))
        s = entry(OUTSIDE if at is None else ranges.innermost(at))
        s["kernels"] += 1
        s["kernel_s"] += e["dur"] / 1e6
        launches_in_trips += at is not None and ranges.in_trip(at)
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS and "dur" in e and e.get("ph", "X") == "X")
    end = None
    for start, stop in dev:
        if end is not None and start > end:
            entry(ranges.innermost(end))["idle_s"] += (start - end) / 1e6
        end = stop if end is None else max(end, stop)
    idle = sorted(([k, v["idle_s"]] for k, v in spans.items() if v["idle_s"]),
                  key=lambda kv: -kv[1])
    return {"spans": spans, "launches_in_trips": int(launches_in_trips),
            "syncs_in_trips": int(syncs_in_trips), "idle_by_span": idle}
