"""Profiling hooks: a thin wrapper over ``torch.profiler``, and the spans
and counters the solver marks its phases with.

The port of ``pockit_tpu/utils/profiling.py``. Any solve or batched sweep
can be captured to a Chrome/Perfetto trace::

    with profile_trace("/tmp/pockit-trace") as prof:
        res = ipm.solve_batch(system, guesses)
    prof.key_averages()  # per-op sums; the trace file is in the directory

View the ``.json`` file with ui.perfetto.dev or ``chrome://tracing``.

The solver marks its phases with :func:`span` (``ipm.init``,
``ipm.iteration`` and, inside each trip, ``ipm.assemble`` (on the
block-arrow paths the block assembly inside it, ``ipm.assemble.blocks``),
``ipm.newton``, ``ipm.line_search``, ``ipm.update``; then
``ipm.finalize``; each drain round of ``solve_batch_drained`` is an
``ipm.drain_round``) and counts events with :func:`count`
(``ipm.factor_tries``: one per rung of the inertia-correction ladder, that
is one factorization; ``ipm.ls_trials``: one per backtracking trial;
``ipm.bound_cut``: the active lanes of a trip whose primal step the
fraction-to-boundary rule on the variable bounds cut below 1, read from
the device only inside a recording; ``kkt.phase_groups``: the phase groups
one block assembly dispatches, one per phase and interval degree). Under
``torch.profiler`` a span is a ``record_function`` range, on the
profiler's clock with the kernels it launches; inside :func:`recording` it
adds its host seconds and calls, and a counter its count, to the
recording::

    with recording() as rec:
        res = ipm.solve_batch(system, guesses)
    rec["spans"]["ipm.newton"]  # {"calls": trips, "s": host seconds}
    rec["counters"]["ipm.factor_tries"]

With neither active a span and a counter do nothing. A span's host
seconds are its dispatch, plus any wait for the device inside it (a
synchronization waits for work that earlier spans launched too).
One recording is open at a time, per process, not per thread.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

_REC = None  # the open recording, if any


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


@contextmanager
def recording():
    """Collect the spans and counters of the enclosed work: yields
    ``{"spans": {name: {"calls": int, "s": float}}, "counters": {name:
    int}}``, filled as the work runs (host seconds, by
    ``time.perf_counter_ns``). One recording is open at a time: opening a
    second inside it raises ``RuntimeError``."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    _REC = rec = {"spans": {}, "counters": {}}
    try:
        yield rec
    finally:
        _REC = None


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the open recording, if any."""
    if _REC is not None:
        _REC["counters"][name] = _REC["counters"].get(name, 0) + n


def recording_on() -> bool:
    """Whether a :func:`recording` is open: a counter whose count needs a
    read from the device asks first, so that no sync is added when nobody
    records."""
    return _REC is not None


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name):
        self.name = name
        self._range = self._t0 = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _REC is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None and _REC is not None:
            entry = _REC["spans"].setdefault(self.name, {"calls": 0, "s": 0.0})
            entry["calls"] += 1
            entry["s"] += (time.perf_counter_ns() - self._t0) / 1e9
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _Phases:
    """Sequential phase marks: ``mark(name)`` closes the open phase and
    opens ``name`` (``None``: opens none); leaving the block closes the
    open one, also when the block raises."""

    __slots__ = ("_open",)

    def __init__(self):
        self._open = None

    def __enter__(self):
        return self

    def __call__(self, name):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            self._open = _Span(name).__enter__()

    def __exit__(self, *exc):
        if self._open is not None:
            self._open.__exit__(*exc)
            self._open = None
        return False


class _Off:
    """What :func:`span` and :func:`phases` give with nothing active: a
    context that does nothing and a mark that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name):
        pass


_OFF = _Off()


def span(name: str):
    """A context marking the phase ``name``: a ``record_function`` range
    under ``torch.profiler``, host seconds and a call in the open
    :func:`recording`; with neither active, a shared context that does
    nothing."""
    if _REC is not None or torch.autograd._profiler_enabled():
        return _Span(name)
    return _OFF


def phases():
    """A context yielding ``mark``: ``mark(name)`` ends the phase open in
    the block and opens the span ``name`` (``None``: none), so a long
    function is cut into phases without nesting it in ``with`` blocks.
    With nothing active, ``mark`` does nothing."""
    if _REC is not None or torch.autograd._profiler_enabled():
        return _Phases()
    return _OFF
