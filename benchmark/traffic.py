"""The one generator of every traffic mix.

A mix is a data file, ``benchmark/traffic/<mix>.json``: the ``kind`` of its
calls (``benchmark/kinds/<kind>.py`` makes them), their precision, batch,
guess and solver options, and the draws of each named parameter, which the
configuration's ``boundary`` turns into boundary values. ``start`` draws a
batch's parameters once, before its first call; ``draws`` draws them again
for every call. A draw is ``{"uniform": [lo, hi]}``, ``{"constant": v}``, or
``{"normal": sd}`` (a drift: added to the parameter's last value); a
``"clip": [lo, hi]`` bounds the result. Every draw comes from
``numpy.random.default_rng(seed)``, in the order of the calls, so one seed
gives one sequence of inputs whatever the run's length.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent / "traffic"


def load(mix: str) -> dict:
    return json.loads((DIR / f"{mix}.json").read_text())


def _draw(rng, spec: dict, B: int, last=None) -> np.ndarray:
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        v = rng.uniform(lo, hi, B)
    elif "normal" in spec:
        v = last + rng.normal(0.0, spec["normal"], B)
    elif "constant" in spec:
        v = np.full(B, float(spec["constant"]))
    else:
        raise ValueError(f"unknown draw {spec}")
    if "clip" in spec:
        v = np.clip(v, *spec["clip"])
    return v


class Stream:
    """The inputs of one run: ``start`` holds the parameters drawn before
    the first call (``None`` where the mix draws none); ``next()`` gives
    the parameters of the next call."""

    def __init__(self, mix: dict, seed: int, batch: int):
        self.mix, self.B = mix, batch
        self.rng = np.random.default_rng(seed)
        self.start = None
        if "start" in mix:
            self.start = {k: _draw(self.rng, s, batch) for k, s in mix["start"].items()}
        self.last = self.start or {}

    def next(self) -> dict:
        drawn = {k: _draw(self.rng, s, self.B, self.last.get(k))
                 for k, s in self.mix["draws"].items()}
        self.last = {**self.last, **drawn}
        return self.last
