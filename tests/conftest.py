"""Test configuration: run everything on CPU with an 8-device virtual mesh.

The suite runs on the host CPU; sharding tests run against XLA's
host-platform virtual devices (SURVEY.md §4.4). The GPU path is driven by
``python chip_smoke.py [--four]`` on a machine with the card. Tests that
need a card carry the ``gpu`` marker and take the ``gpu_devices`` fixture,
which skips them when JAX finds no GPU. Must run before jax is imported
anywhere.
"""

import os
import sys

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture
def gpu_devices():
    """JAX's GPU devices; skips the test when there is no card (decided
    here, at run time, never while a module is imported)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devs
