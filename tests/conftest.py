"""Test harness: JAX on a virtual 8-device CPU mesh, so the sharding paths run
without GPUs (SURVEY §4 layering (d)).

Tests marked ``gpu`` need an NVIDIA GPU. They skip on the CPU and run on the
card with ``python -m pytest tests/ -m gpu``; only that marker run leaves the
platform to JAX instead of forcing the CPU.
"""

import os
import tempfile

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped on the CPU; run on the "
        "card with `python -m pytest tests/ -m gpu`)")
    if config.getoption("markexpr", "") != "gpu":
        jax.config.update("jax_platforms", "cpu")
    # persistent compilation cache: XLA compiles dominate test wall time
    # (a run started from a program that already chose a cache keeps it)
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update(
            "jax_compilation_cache_dir",
            os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(tempfile.gettempdir(), "phyngsc_jax_cache"))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest tests/ -m gpu` "
                    "on the card")
