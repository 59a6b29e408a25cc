"""Test configuration: the CPU backend with 8 devices, plus a `gpu` marker.

Tests run on JAX's CPU backend unless JAX_PLATFORMS says otherwise, and
the CPU backend is split into 8 devices so the sharded paths have a mesh
to run on. Tests marked `gpu` need an NVIDIA GPU and skip without one;
run them on the card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# cache small compiles too: repeat runs and xdist workers share them
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax  # noqa: E402
import pytest  # noqa: E402

# must precede the first backend initialisation (khmer_tpu's import
# does not initialise one)
jax.config.update("jax_num_cpu_devices", 8)


REFERENCE_DATA = "/root/reference/tests/test-data"
REFERENCE_BIGDATA = "/root/reference/data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on other backends")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend here: %s)"
                    % dev.platform)
    return dev


def reference_file(name):
    path = os.path.join(REFERENCE_DATA, name)
    if not os.path.exists(path):
        pytest.skip("reference test data %s not available" % name)
    return path


@pytest.fixture
def tmpfile(tmp_path):
    def make(name):
        return str(tmp_path / name)

    return make
