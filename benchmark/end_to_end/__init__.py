"""End-to-end metric readers: ``<metric>.py`` reads every end-to-end metric
whose name is ``<metric>`` or starts with ``<metric>.``, with ``read(ctx,
name) -> float``. ``ctx`` holds the run's host-clock readings
(``benchmark/harness.py``, ``run_cell``): ``setup_s``, ``span_s`` (the
window's start to the end of the last call started in it), ``calls`` and
``status`` (every lane of every call of the window, 0 where converged)."""
