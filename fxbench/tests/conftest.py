"""The benchmark's own tests (run with `python -m pytest fxbench/tests -q`
from the repository's root).  Tests marked `cuda` need the card and skip
without one; they decide that inside the test."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")
