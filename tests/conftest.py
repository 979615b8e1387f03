"""Test environment: the CPU backend with an 8-device virtual mesh.

Multi-device sharding paths are validated on the virtual CPU mesh (the
standard JAX way to test pjit/shard_map without several cards). The suite
runs on the CPU unless JAX_PLATFORMS says otherwise. Tests that need a GPU
carry the `gpu` marker and take the `gpu_device` fixture, which skips them
where there is none; run them on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# XLA:CPU executable serialization has crashed inside
# compilation_cache.put_executable_and_time during test_optim; the suite
# compiles small programs that the persistent cache does not pay for.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips elsewhere (run with -m gpu)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU backend in this process")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """XLA:CPU has crashed inside backend_compile once enough programs had
    accumulated in one process (reproducibly at the same point of a full
    run, while every module passed in isolation). Dropping the in-process
    executable caches between modules keeps the compiler healthy at the
    cost of recompiling shared kernels per module."""
    yield
    jax.clear_caches()
