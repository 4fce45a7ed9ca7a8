"""Test configuration: CPU with 8 virtual devices unless told otherwise.

Tests run on the host platform so they are deterministic, fast to compile,
and can exercise multi-device sharding (8 virtual devices) without a GPU.
``JAX_PLATFORMS`` is only defaulted: the tests marked ``gpu`` run on the
card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
Must run before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)  # f64 available for oracle tests
# never reuse persistent compile artifacts in tests (machine-feature drift)
jax.config.update("jax_compilation_cache_dir", None)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU device: this test compiles for the card")
