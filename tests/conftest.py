"""Test configuration.

The suite runs on JAX's CPU backend with a virtual 8-device mesh, so the
numerics and the multi-device sharding are checked on any host.  An
explicit JAX_PLATFORMS wins: tests marked ``gpu`` need an NVIDIA GPU, skip
without one, and run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(7654)


@pytest.fixture
def gpu():
    """The first GPU JAX sees; the test is skipped when there is none.
    Decided here, at run time, so every test worker collects the same
    tests."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    return gpus[0]
