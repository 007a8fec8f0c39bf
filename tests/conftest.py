"""Test configuration: force CPU with an 8-device virtual mesh.

Multi-device sharding is validated on virtual CPU devices; numeric kernels
behave identically. Must run before jax imports.

GPU-gated tests (marker ``gpu``) compile the Triton kernels for the card
and compare them with the XLA references. They skip on the CPU; on a GPU
host ``PW2V_GPU_TESTS=1 python -m pytest tests/test_gpu_kernels.py`` runs
them (``chip_smoke.py`` runs the same tests in its own process).
"""

import os

_GPU_MODE = bool(int(os.environ.get("PW2V_GPU_TESTS", "0")))

if not _GPU_MODE:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not _GPU_MODE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU backend (PW2V_GPU_TESTS=1)")


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    """Skip ``gpu``-marked tests off the GPU and the CPU suite in GPU mode.
    Decided per test at run time, never at import or collection, so every
    xdist worker collects the same tests."""
    on_gpu = _GPU_MODE and jax.default_backend() == "gpu"
    marked = request.node.get_closest_marker("gpu") is not None
    if marked and not on_gpu:
        pytest.skip("GPU-only (set PW2V_GPU_TESTS=1 on a GPU host)")
    if not marked and _GPU_MODE:
        pytest.skip("CPU suite skipped in GPU mode (one card, no virtual "
                    "mesh)")


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of execution order.
    return np.random.default_rng(0)
