"""Test configuration: CPU backend with 8 virtual devices + float64.

The reference's own test oracle is the CPU/Threads backend in Float64
(test/runtests.jl re-execs Julia with -O3; USE_GPU=false in
NavierStokes3D_multi_gpu.jl:1). We mirror that: tests run on the CPU
backend with x64 enabled, and sharding tests use 8 virtual host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8) so an 8-way mesh
decomposition is exercised without multi-GPU hardware.

Tests marked `gpu` need an NVIDIA GPU: they request the `gpu_backend`
fixture, which skips them unless JAX's default backend is the GPU.
chip_smoke.py runs them on the card with JAX_PLATFORMS=cuda.
"""

import os

import pytest

# persistent compile cache: repeat suite runs skip CPU recompiles
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".cache", "jax"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at collection, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
