"""Test configuration.

Runs the whole suite on CPU with 8 virtual devices so multi-device
sharding (``jax.sharding.Mesh``) is exercised without accelerators —
the strategy SURVEY.md §4 prescribes (the reference has no distributed
tests to model this on).  Must run before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Also pin the platform in config, in case a plugin initialised a backend
# before the environment variable was read.
jax.config.update("jax_platforms", "cpu")

# x64 lets algorithm-parity tests compare against float64 oracles exactly;
# production precision (f32/bf16) is covered by dedicated tolerance tests.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
