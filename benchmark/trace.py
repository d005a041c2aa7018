"""Reading a ``torch.profiler`` Chrome trace of one profiled call: the
device's busy intervals, its kernels by name, the longest idle gaps with
what the host was doing in each, and the IPM trips (``ipm.iteration``
ranges).

Device work is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; busy time is the union of their intervals. A gap is a
stretch between two busy intervals, labelled with the innermost host event
open when it began (a range, an aten op or a CUDA runtime call: the one
that began last).
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
PORT_KERNELS = ("factor", "apply_down", "apply_up")  # the port's CUDA kernels, <name>_kernel


def port_kernel(name: str):
    """Which of the port's kernels a device event is, or ``None``."""
    for k in PORT_KERNELS:
        if f"{k}_kernel" in name:
            return k
    return None


def read(path: str) -> dict:
    """Summary of the trace at ``path`` (times in seconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return summarize(events)


def summarize(events: list) -> dict:
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"], e.get("args", {}))
                 for e in events
                 if e.get("cat") in DEVICE_CATS and "dur" in e and e.get("ph", "X") == "X")
    merged = []
    for start, stop, *_ in dev:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    busy_us = sum(b - a for a, b in merged)
    by_name = {}
    port = {k: [] for k in PORT_KERNELS}
    for start, stop, name, cat, args in dev:
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
        k = port_kernel(name) if cat == "kernel" else None
        if k:
            port[k].append({"ts": start, "dur_s": (stop - start) / 1e6, "args": args})
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e and e.get("ph") == "X"]
    trips = sum(1 for e in host if e["cat"] == "user_annotation" and e["name"] == "ipm.iteration")
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:10]
    idle = []
    for dur, at in gaps:
        open_ = [e for e in host if e["ts"] <= at < e["ts"] + e["dur"]]
        label = max(open_, key=lambda e: (e["ts"], -e["dur"]))["name"] if open_ else "(no host event)"
        idle.append([label[:80], dur / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_events": len(dev),
        "busy_s": busy_us / 1e6,
        "trips": trips,
        "port": port,
        "device_ops": [[name[:80], us / 1e6] for name, us in top],
        "idle_gaps": idle,
    }
