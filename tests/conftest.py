"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
paths are exercised without accelerator hardware.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when JAX finds no GPU; the
decision is made when the fixture runs, never at import.  On the GPU their
phases are run by ``python chip_smoke.py``."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import pytest

DATA = pathlib.Path("/root/reference/src/pyhmmer/tests/data")


def pytest_configure(config):
    config.addinivalue_line("markers", "golden: tests needing reference data")
    config.addinivalue_line(
        "markers", "gpu: tests that need an NVIDIA GPU (skipped without one)")


@pytest.fixture(scope="session")
def data_dir():
    if not DATA.exists():
        pytest.skip("reference test data not available")
    return DATA


@pytest.fixture(scope="session")
def gpu_device():
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")
    return devs[0]
