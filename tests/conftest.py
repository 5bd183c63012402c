"""Test harness: 8 virtual CPU devices so multi-device sharding logic is
exercised without a cluster (SURVEY.md §4.4), and one ``gpu`` marker.

CPU runs pin the platform from the environment:

    JAX_PLATFORMS=cpu python -m pytest tests/ -m 'not slow'

Tests marked ``gpu`` need a GPU; a fixture skips them when JAX's default
backend is not the GPU, decided when the test runs (never at import, so
every xdist worker collects the same tests).  On a card they run inside
``chip_smoke.py``'s process (``pytest -m gpu tests/``).
"""

import os

_FLAG = "--xla_force_host_platform_device_count"
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" {_FLAG}=8")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped when JAX's default backend "
                   "is not the GPU")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture(autouse=True)
def _skip_gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(f"needs a GPU; JAX's default backend is "
                    f"{jax.default_backend()!r}")
