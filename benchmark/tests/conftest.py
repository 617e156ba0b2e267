"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.
Tests that need a CUDA card carry the ``cuda`` marker and skip inside the
test where there is none; on the card: ``python -m pytest benchmark/tests
-q -m cuda``."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips inside the test without "
        "one)")
