"""pytest settings of the benchmark's own tests (benchmark/tests/): the
repository root on the import path, and the marker of tests that need a
card."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
