"""Shared fixtures.  NOTE: no XLA_FLAGS device forcing here — smoke tests
and benches must see 1 device (only launch/dryrun.py forces 512).  Tests
that need a multi-device mesh spawn subprocesses (test_distribution.py).
"""
import os
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))


@pytest.fixture(scope="session")
def rng_key():
    import jax
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's CUDA kernels); "
        "skipped where there is none")
