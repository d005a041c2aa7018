"""Profiling hooks: a thin wrapper over ``torch.profiler``.

The port of ``pockit_tpu/utils/profiling.py``. Any solve or batched sweep
can be captured to a Chrome/Perfetto trace::

    with profile_trace("/tmp/pockit-trace") as prof:
        res = ipm.solve_batch(system, guesses)
    prof.key_averages()  # per-op sums; the trace file is in the directory

View the ``.json`` file with ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


@contextmanager
def profile_trace(log_dir: str):
    """Context manager capturing a host profile of the enclosed ops and,
    where a CUDA card is present, its device activity; on exit writes
    ``trace_<ns>.json`` (Chrome trace format) into ``log_dir``. Yields the
    ``torch.profiler.profile`` object, whose ``trace_path`` attribute names
    the written file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
