"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the checkout's root (on the CPU; the one test marked ``gpu`` needs a
card and skips without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skipped without one)")
