"""CPU tests of the benchmark (``python3 -m pytest gpbench/tests -q``); the
tests marked ``gpu`` run one cell on a card and skip, inside the test,
where there is none."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside the test) when there is none")
