"""mcport — a GPU Monte-Carlo portfolio framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
``mohammadmarghzari/monte-carlo-portfolio`` (a Streamlit portfolio simulator):
data ingestion, risk statistics, option-hedging strategies, random-weight +
exact (PGD QP) portfolio optimization, seven tail-risk model families (GBM with
normal or Student-t innovations, CCC-GARCH(+t), DCC-GARCH, Merton systemic
jumps, Heston stochastic volatility, stationary block bootstrap; the GBM paths
on fused Triton kernels), mesh-sharded reductions with
bit-exact checkpoint/resume and elastic recovery, ARIMA (exact Kalman MLE) +
GARCH forecasting, and a UI parity layer.

Layers (SURVEY.md §7): data → stats → options → models/ops → parallel → engine →
api/cli → ui. Ingestion is NumPy + the stdlib csv module; everything below it
is pure JAX.
"""

__version__ = "0.2.0"

import os as _os
import sys as _sys


def _set_jax_default(name: str, value: str) -> None:
    """Set a JAX config value now if jax is imported, else through the env
    var JAX reads when it is imported."""
    if "jax" in _sys.modules:
        _sys.modules["jax"].config.update(name.lower(), value)
    else:
        _os.environ.setdefault(name.upper(), value)


# By default XLA runs float32 matmuls on the GPU's tensor cores in TF32
# (10-bit mantissa, ~1e-3 relative error per product). For a risk framework
# that promises 1e-6 parity with its NumPy reference, that silent truncation is
# wrong-by-default: force float32 matmul precision process-wide. Fast paths
# that WANT reduced operands request them explicitly (the drawdown kernel's
# score_dtype="tensorfloat32"/"bfloat16"), which this setting does not affect.
# Override with MCPORT_MATMUL_PRECISION=default to restore JAX's own default,
# or any valid jax_default_matmul_precision value.
_prec = _os.environ.get("MCPORT_MATMUL_PRECISION", "float32")
if _prec != "default":
    _set_jax_default("jax_default_matmul_precision", _prec)

# Persistent compile cache: JAX_COMPILATION_CACHE_DIR when it is set (JAX
# reads it itself), otherwise <checkout>/.jax_cache.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _set_jax_default(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                      ".jax_cache"))
del _os, _sys, _prec, _set_jax_default

from mcport.config import Config, DataConfig, ForecastConfig, GBMConfig, MeshConfig
from mcport.config import PayoffConfig, PortfolioConfig, SimulationConfig, SketchConfig


def __getattr__(name):
    """Lazy re-exports of the workflow API (mcport.load_universe, mcport.simulate,
    ...) without importing jax/pandas at package-import time."""
    _API = ("load_universe", "compute_stats", "simulate", "gbm_risk",
            "hedged_tail_risk",
            "bootstrap_tail_risk", "exact_mv_frontier", "exact_cvar_frontier",
            "exact_cdar_frontier",
            "risk_based_weights", "compare_tail_risk", "forecast")
    if name in _API:
        import mcport.api as _api

        return getattr(_api, name)
    raise AttributeError(f"module 'mcport' has no attribute {name!r}")

__all__ = [
    "Config",
    "DataConfig",
    "PortfolioConfig",
    "SimulationConfig",
    "GBMConfig",
    "SketchConfig",
    "MeshConfig",
    "ForecastConfig",
    "PayoffConfig",
    "__version__",
]
