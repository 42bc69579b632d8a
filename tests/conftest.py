"""Suite-wide defaults. This conftest runs before any test module
imports jax, so the env vars below are set before the backend
initializes — fresh runners (CI or laptops with GPUs) get the same
deterministic single-CPU-device configuration the suite is written for.

``setdefault`` only: an explicit environment wins, which is how the
sharded-parity tier runs this same suite under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(scripts/ci.sh test-sharded), and how the subprocess sharding tests
force their own device counts.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=1")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped (from inside the "
        "test) where torch.cuda.is_available() is false")
