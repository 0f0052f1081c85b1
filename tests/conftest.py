"""Test harness configuration.

Default (CPU) tier:
- Forces the CPU backend with 8 virtual devices so mesh/sharding/collective tests
  run without several accelerators (SURVEY.md §4 "multi-chip without a pod").
- Enables x64 so golden-value parity tests can assert 1e-6+ agreement with the
  NumPy reference formulas (BASELINE.json "moments match ... to 1e-6").

GPU tier: ``MCPORT_GPU=1 python -m pytest tests/test_gpu_kernels.py -m gpu -o
addopts=`` keeps JAX's own platform and runs the ``gpu``-marked tests in one
process, which exercise the COMPILED Triton kernels at real widths. Whether a GPU is present is decided inside the ``gpu``
fixture those tests request, never at import or collection time, so every
pytest-xdist worker collects the same tests.

Must set env vars before the first ``import jax`` anywhere in the test session.
"""

import os
import sys
from pathlib import Path

GPU_TIER = os.environ.get("MCPORT_GPU") == "1"

if not GPU_TIER:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # Suppress XLA's per-load E-log about the +prefer-no-scatter/gather
    # pseudo-features when reloading persistent-cache AOT results (benign:
    # those are compiler hints the host feature parser doesn't know, not
    # real ISA requirements; everything else in the feature lists matches).
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

# repo root on sys.path so `import mcport` works without installation
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

import mcport  # noqa: E402,F401  (sets the compile cache, see mcport/__init__.py)

if not GPU_TIER:
    jax.config.update("jax_enable_x64", True)
    # Suite diet: persist compiled XLA:CPU executables across workers and
    # runs (mcport/__init__.py picks the directory); the heavy interpret-mode
    # kernel graphs compile once, then every other xdist worker AOT-loads them.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"


@pytest.fixture
def gpu():
    """The GPU the ``gpu``-marked tests run on; skips where there is none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run: python chip_smoke.py)")
    return devices[0]


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Drive engines through their fused-kernel path on the CPU: kernels run
    in Pallas interpret mode (mcport.ops.dispatch)."""
    from mcport.ops import dispatch

    monkeypatch.setattr(dispatch, "_interpret", True)


@pytest.fixture(scope="session")
def fixtures_dir() -> Path:
    return FIXTURES


@pytest.fixture(scope="session")
def rng() -> np.random.Generator:
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]
