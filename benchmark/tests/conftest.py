"""Tests of the benchmark: on the CPU, except those marked ``gpu``, which
decide inside the test whether a card is there (run them on the card with
``python -m pytest benchmark/tests -m gpu``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")
