"""Per-layer metric readers: ``<metric>.py`` reads every metric whose name
is ``<metric>`` or starts with ``<metric>.``, with ``read(ctx, name) ->
float | None``. ``ctx`` is the run's record (``benchmark/harness.py``,
``layer_context``); a reader that finds nothing to read returns ``None``,
and the metric is left out of the result's line."""
