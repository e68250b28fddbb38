import os
import sys

# smoke tests and benches must see exactly ONE device; only the dry-run
# (launch/dryrun.py) sets the 512-device flag, and only in its own process.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
