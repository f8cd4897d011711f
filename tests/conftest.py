"""Test configuration: force the CPU backend with 8 virtual devices.

Tests never require a GPU: single-device numerics run on one virtual CPU
device; multi-device sharding tests use an 8-device CPU mesh — the standard
JAX pattern for testing collectives clusterlessly.  Tests that need the card
carry the ``gpu`` marker and skip inside the test body (never at import or
collection time: xdist workers must collect identical test lists).

The platform is also flipped via jax.config, which works even when jax was
imported before pytest started.
"""

import os

# Must be set before the CPU client is instantiated (first jax computation).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu"
    return devs
