"""Test configuration: JAX on a virtual 8-device CPU mesh, x64 on.

Multi-chip sharding is tested without accelerators via
xla_force_host_platform_device_count (see SURVEY.md §4).  This must run
before jax initializes its backends, hence the env setup at import time.
``JAX_PLATFORMS`` defaults to cpu; tests marked ``gpu`` need a card and
skip without one (on a GPU host: ``JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/``).
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-GB / multi-minute parity tests")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {dev.platform})")
    return dev
