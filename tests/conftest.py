"""Test configuration.

Forces the CPU backend with 8 virtual devices (the fake backend for
multi-device sharding tests) and enables float64 for bit-parity physics
tests.  The platform is switched via ``jax.config`` before first use, so
the tests run on the CPU even on a machine with a GPU.
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))

from resources.astra_fixture import ensure_fixture  # noqa: E402

RESOURCES = Path(__file__).parent / "resources"


@pytest.fixture(scope="session")
def astra_beam_path() -> str:
    """Path to the (generated-on-demand) synthetic ASTRA fixture."""
    return str(ensure_fixture(RESOURCES))
