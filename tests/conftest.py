"""Test configuration: CPU with 8 virtual devices (multi-device sharding
tests run on a virtual mesh) and x64 for exact-oracle comparisons.

Must run before jax initialises its backends, hence env vars at import time.
`JAX_PLATFORMS` is honoured when already set, so the tests marked `gpu` can
run on a card: `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided
    when the test runs, never at import, so every worker collects the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev
