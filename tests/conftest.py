"""Test configuration.

Parity tests run on CPU in float64 (the reference is float64 numpy), with a
virtual 8-device mesh so multi-device sharding logic is exercised without
GPUs. Environment must be set before jax is imported anywhere. Tests marked
``gpu`` need a card and skip here (the ``gpu_device`` fixture decides).
"""

import os
import sys
from pathlib import Path

# SALAMANDER_TEST_GPU=1 leaves the platform and dtype defaults alone, for
# running the gpu-marked tests on a card (python -m pytest -m gpu tests/)
ON_GPU_LANE = os.environ.get("SALAMANDER_TEST_GPU") == "1"
if not ON_GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402

# Set the config as well as the variable, AFTER the jax import, so parity
# tests run on CPU even where the platform list was configured earlier.
if not ON_GPU_LANE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Golden fixtures produced by the reference implementation (read-only mount).
REFERENCE_DATA = Path(
    os.environ.get("SALAMANDER_REFERENCE_DATA", "/root/reference/tests/test_data")
)

requires_reference_data = pytest.mark.skipif(
    not REFERENCE_DATA.exists(),
    reason="reference golden fixtures not available",
)


@pytest.fixture(scope="session")
def reference_data_path():
    if not REFERENCE_DATA.exists():
        pytest.skip("reference golden fixtures not available")
    return REFERENCE_DATA


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU; skips the test where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (on a card: SALAMANDER_TEST_GPU=1 "
                    "python -m pytest -m gpu tests/)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop jit/compile caches after every test module.

    A full-suite run compiles thousands of XLA CPU programs in one
    process; with all caches retained, the suite once segfaulted inside
    XLA's backend_compile_and_load near its end (compiler-state
    corruption, not OOM; every module passes in isolation). Per-module
    cache clearing bounds the accumulated compiler state; cross-module
    recompiles cost seconds."""
    yield
    jax.clear_caches()
