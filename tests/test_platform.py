"""The platform decision, the compile cache, the import boundary and the GPU
smoke script's refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from mcport.ops import dispatch

ROOT = Path(__file__).resolve().parent.parent


def _run(code_or_argv, env=None, cwd=ROOT, timeout=300):
    argv = ([sys.executable, "-c", code_or_argv] if isinstance(code_or_argv, str)
            else [sys.executable, *code_or_argv])
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    base["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(argv, capture_output=True, text=True, timeout=timeout,
                          cwd=str(cwd), env={**base, **(env or {})})


# ---- dispatch -----------------------------------------------------------------


@pytest.mark.parametrize("platform,requested,want", [
    ("gpu", None, True),
    ("gpu", True, True),
    ("gpu", False, False),
    ("cpu", None, False),
    ("cpu", False, False),
])
def test_use_kernels_by_platform(monkeypatch, platform, requested, want):
    monkeypatch.setattr(dispatch, "_platform", lambda: platform)
    assert dispatch.use_kernels(requested) is want


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_kernel_demanded_off_gpu_raises(monkeypatch, platform):
    monkeypatch.setattr(dispatch, "_platform", lambda: platform)
    with pytest.raises(dispatch.KernelPlatformError):
        dispatch.use_kernels(True)
    with pytest.raises(dispatch.KernelPlatformError):
        dispatch.kernel_interpret(False)


def test_interpret_only_off_gpu(monkeypatch):
    assert dispatch.kernel_interpret(True) is True        # CPU: interpreted
    monkeypatch.setattr(dispatch, "_platform", lambda: "gpu")
    assert dispatch.kernel_interpret(False) is False      # GPU: compiled
    with pytest.raises(dispatch.KernelPlatformError):
        dispatch.kernel_interpret(True)


def test_interpret_fixture_routes_engines_to_kernels(interpret_kernels):
    assert dispatch.use_kernels(None) is True
    assert dispatch.kernel_interpret(False) is True
    assert dispatch.use_kernels(False) is False


def test_engine_refuses_kernel_on_cpu():
    """Asking an engine for the kernel where it cannot compile is an error,
    not a quiet fallback to the lax form."""
    import numpy as np

    from mcport.config import GBMConfig
    from mcport.engine.mc_engine import run_resumable_mc
    from mcport.models.gbm import GBMParams

    p = GBMParams(s0=np.ones(2), mean_step=np.full(2, 1e-3),
                  chol_step=np.eye(2) * 0.01)
    with pytest.raises(dispatch.KernelPlatformError):
        run_resumable_mc(p, np.full(2, 0.5),
                         GBMConfig(n_paths=256, path_block=256, n_steps=4,
                                   use_pallas=True))


# ---- compile cache ------------------------------------------------------------

_CACHE_DIR = "import mcport, jax; print(jax.config.jax_compilation_cache_dir)"


def test_compile_cache_defaults_to_checkout(tmp_path):
    out = _run(_CACHE_DIR, env={"PYTHONPATH": str(ROOT)}, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(ROOT / ".jax_cache")


def test_compile_cache_follows_environment(tmp_path):
    out = _run(_CACHE_DIR, env={"PYTHONPATH": str(ROOT),
                                "JAX_COMPILATION_CACHE_DIR": str(tmp_path)},
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(tmp_path)


# ---- pandas stays off the main path -----------------------------------------------


def test_gbm_risk_runs_without_pandas(fixtures_dir):
    eth = str(fixtures_dir / "ETH_USD 7 Years Weekly.csv")
    code = (
        "import sys; sys.modules['pandas'] = None\n"
        "from mcport.cli import main\n"
        f"main(['gbm-risk', {eth!r}, '--period', 'W', '--paths', '2048',"
        " '--steps', '4'])\n"
        "assert sys.modules['pandas'] is None\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)["n_paths"] == 2048


# ---- chip_smoke.py ------------------------------------------------------------


def test_chip_smoke_refuses_without_gpu():
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
