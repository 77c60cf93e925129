"""Tests of the benchmark harness (CPU; the `gpu` ones skip without a
card). Run from the repository's root:

    python -m pytest bench_h100/tests -q
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")
