"""Test configuration: an 8-device virtual CPU platform so the sharding
tests run without accelerators (set BEFORE jax import).

An explicitly set JAX_PLATFORMS is kept, so the GPU-marked tests can run on
the card (chip_smoke.py runs them there); the default is the CPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")
