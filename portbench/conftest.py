"""pytest settings of the benchmark's own tests (``portbench/tests``): the
benchmark's folder and the checkout's root on the import path, and the
``card`` marker of tests that need a CUDA card (each decides inside the
test whether there is one, and skips there)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips inside the test without one")
