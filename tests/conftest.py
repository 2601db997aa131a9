"""Test harness.

The suite runs on the CPU with 8 virtual devices, so the distributed tests
can build a jax.sharding.Mesh without accelerators (SURVEY.md §4). Tests
of code that only runs on a GPU carry the `gpu` marker and take the `gpu`
fixture, which skips them unless JAX computes on a GPU; they run on the
card with `python -m pytest -m gpu tests/` (chip_smoke.py runs them
in-process). Selecting exactly that marker leaves JAX's platform alone.
"""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips elsewhere; run with -m gpu)")
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # the suite re-jits the same render graphs each run
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    import jax

    from hobbyraytracer_tpu.runtime import enable_compile_cache

    jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU (decided when the test runs)."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX computes on {platform}")
