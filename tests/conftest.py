"""Test configuration: force an 8-device CPU platform before JAX loads.

Multi-chip sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``), the JAX-native mechanism for
testing pjit/shard_map programs without real hardware.
"""

import os

# the card's own tests (marked ``gpu``) run with JAX_PLATFORMS=cuda set by
# the caller; every other run is held to the CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_DIR, "data"))


requires_reference = pytest.mark.skipif(
    not reference_available(),
    reason="reference data artifacts not present",
)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
