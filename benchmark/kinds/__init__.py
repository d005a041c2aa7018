"""Kinds of call: ``<kind>.py`` makes the calls of every mix whose ``kind``
is ``<kind>``, through the port's entry points, with

- ``setup(run)``: warm every shape the mix's calls use;
- ``call(run, params) -> dict``: one call on ``params`` (the traffic's next
  draw), returning at least ``status``, ``obj``, ``iterations`` (each per
  lane) and ``z`` (each lane's solution, ``(B, L)``), and what ``repeat``
  needs;
- ``repeat(run, rec) -> dict``: the call that made ``rec`` again, on the
  same inputs.

``run`` is the harness's ``CellRun``: the problem, batch, type, device,
the mix, the options (``run.ip_options(key)``), boundary values
(``run.bc(params)``), the guess (``run.guess()``) and ``run.state``, where
a kind keeps what its calls carry from one to the next. The harness times
each call and synchronises the device after it."""
