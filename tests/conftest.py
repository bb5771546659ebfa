"""Test configuration: run on CPU with 8 virtual devices and float64 enabled.

Multi-device sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count=8); numerical parity tests use f64.

The suite runs on the CPU unless JAX_PLATFORMS names another platform.
Tests marked `gpu` need an NVIDIA card and skip elsewhere; run them on a
card with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.  The jax
config objects are updated directly, since a jax imported before pytest
starts has already read the environment.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_ENABLE_X64"] = "true"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache): XLA compiles dominate the suite's wall time, and
# the cache key hashes the HLO, so edited computations recompile.
from adiabatic_raytracer import runtime  # noqa: E402

runtime.setup_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a `gpu`-marked test unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        platform = jax.devices()[0].platform
        if platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU (JAX platform {platform!r})")
