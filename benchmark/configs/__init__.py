"""Model configurations: ``<name>.json`` holds a configuration's sizes and
constants as run, and ``<name>.py`` builds it through the port's frontend
with ``build(cfg) -> Problem``, ``boundary(problem, params) -> tuple`` (the
fixed boundary values of each lane, one ``(B, n_fixed)`` array per phase)
and ``decode(problem, z) -> dict`` (the parts of each lane's solution that
the configuration's plain reference, ``benchmark/reference/<name>.py``,
also returns)."""

from __future__ import annotations

from typing import NamedTuple


class Problem(NamedTuple):
    system: object  # the port's System
    guesses: dict  # name -> one lane's NLP vector (numpy, float64)
