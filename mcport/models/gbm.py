"""Correlated geometric-Brownian-motion path engine — pure ``jax.lax`` reference.

This is new-build scope: the reference repo never simulates price paths ("Monte
Carlo" there means random portfolio *weights* over historical moments,
app.py:699-717; see SURVEY.md §2 "GBM is implied, not implemented"). BASELINE.json:5
mandates a correlated-GBM engine anchored on the reference's moment-estimation
semantics (app.py:679-680: ``mean()*ann`` / ``cov()*ann``, pandas ddof=1).

Model: per-step log increment ``dlogS = m + L z sqrt(dt_scale)`` where ``m`` is the
estimated per-step mean log return, ``L`` the Cholesky factor of the per-step
log-return covariance, and ``z ~ N(0, I)``. Estimating ``m`` directly from log
returns already folds in the -sigma^2/2 Ito correction, so simulated moments match
the historical estimates by construction.

Everything here is the *reference implementation* for parity tests; the fused
Pallas kernel in :mod:`mcport.ops.pallas_gbm` must match it draw-distribution-wise
and beat it on throughput. RNG is Threefry counter-based and folded per step, so
paths are reproducible, chunkable, and resumable (checkpoint = key + chunk index).

Variance reduction (BASELINE.json:11): ``antithetic=True`` mirrors the z draws of
the second half of each path block; Sobol/Halton terminal sampling lives in
:mod:`mcport.models.qmc` and plugs in via :func:`terminal_log_returns_qmc`.
"""

from __future__ import annotations

import math

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = [
    "GBMParams",
    "estimate_gbm",
    "ledoit_wolf_shrinkage",
    "ewma_cov",
    "estimate_t_dof",
    "terminal_log_returns_t",
    "simulate_log_paths",
    "terminal_log_returns",
    "terminal_log_returns_exact",
    "portfolio_terminal_returns",
]


@dataclass(frozen=True)
class GBMParams:
    """Per-step log-return moments + spot prices.

    ``mean_step`` (A,) and ``chol_step`` (A, A, lower) are in per-step units —
    i.e. already scaled by the analysis period; one simulated step is one period.
    """

    s0: np.ndarray         # (A,) spot prices
    mean_step: np.ndarray  # (A,) per-step mean log return
    chol_step: np.ndarray  # (A, A) Cholesky of the per-step log-return covariance

    @property
    def n_assets(self) -> int:
        return self.s0.shape[-1]


def ledoit_wolf_shrinkage(returns: np.ndarray) -> tuple[np.ndarray, float]:
    """(shrunk covariance, intensity rho) — Ledoit-Wolf (2004) shrinkage of
    the sample covariance toward the scaled identity ``m·I``.

    The optimal intensity ``rho = b^2/d^2`` trades the sample estimator's
    variance (``b^2``, the average squared Frobenius distance of per-row
    outer products from S) against its dispersion around the target
    (``d^2 = ||S − m·I||_F^2``). Small T / large A / heavy noise → rho → 1
    (heavily shrunk, always well-conditioned); long histories → rho → 0
    (the sample estimator is already fine). Intensity is derived in the
    canonical 1/T convention and applied to the repo's ddof=1 S so the
    ``rho = 0`` limit is exactly the reference estimator (app.py:680).
    """
    x = np.asarray(returns, np.float64)
    t, a = x.shape
    xc = x - x.mean(axis=0)
    s_mle = xc.T @ xc / t                       # 1/T convention (LW 2004)
    m = np.trace(s_mle) / a
    d2 = np.sum((s_mle - m * np.eye(a)) ** 2)
    b2_sum = 0.0
    for row in xc:                              # T is small (price history)
        b2_sum += np.sum((np.outer(row, row) - s_mle) ** 2)
    b2 = min(b2_sum / t**2, d2)
    rho = 0.0 if d2 == 0.0 else b2 / d2
    s = np.atleast_2d(np.cov(x, rowvar=False, ddof=1))
    return rho * (np.trace(s) / a) * np.eye(a) + (1.0 - rho) * s, float(rho)


def ewma_cov(returns: np.ndarray, lam: float = 0.94) -> np.ndarray:
    """RiskMetrics exponentially-weighted covariance: weight ``lam^s`` on the
    return ``s`` periods ago (normalized over the finite window), centered on
    the EW mean — recent shocks dominate, so simulated risk reacts to the
    CURRENT volatility regime instead of averaging over the whole history."""
    if not 0.0 < lam < 1.0:
        raise ValueError(f"ewma lambda must be in (0, 1), got {lam}")
    x = np.asarray(returns, np.float64)
    t = x.shape[0]
    w = lam ** np.arange(t - 1, -1, -1.0)       # oldest → newest
    w /= w.sum()
    mu = w @ x
    xc = x - mu
    cov = (xc * w[:, None]).T @ xc
    # ddof-1-style small-sample correction via the effective sample size
    ess = 1.0 / np.sum(w**2)
    return np.atleast_2d(cov * ess / max(ess - 1.0, 1e-12))


def estimate_gbm(prices: np.ndarray, jitter: float = 1e-12,
                 estimator: str = "sample",
                 ewma_lambda: float = 0.94) -> GBMParams:
    """Fit per-step GBM moments from a (T, A) price matrix.

    ``estimator`` selects the covariance tier (the drift is always the
    sample mean of log returns — shrinking the mean is a separate modeling
    decision, covered by Black-Litterman):

    - ``"sample"`` (default) — the reference's estimator family (mean over
      T-1 rows, ddof=1 covariance; app.py:679-680), applied to log prices.
    - ``"lw"`` — Ledoit-Wolf shrinkage toward the scaled identity: the
      short, cross-correlated histories this tool ingests (24-365 rows,
      up to dozens of assets) make the sample covariance ill-conditioned,
      which the downstream Cholesky/optimizers amplify.
    - ``"ewma"`` — RiskMetrics exponentially-weighted covariance
      (``ewma_lambda``, default 0.94): risk reflects the current regime.

    A tiny diagonal jitter keeps Cholesky PD for near-degenerate universes.
    """
    prices = np.asarray(prices, np.float64)
    if prices.ndim != 2 or prices.shape[0] < 3:
        raise ValueError("estimate_gbm needs a (T>=3, A) price matrix")
    if not np.isfinite(prices).all() or (prices <= 0).any():
        # log-return estimation is undefined at zero/negative prices; fail at
        # the boundary with a clear message (failure-detection semantics,
        # SURVEY.md §5) instead of propagating NaNs into the engine.
        raise ValueError("prices must be strictly positive and finite for GBM estimation")
    logret = np.diff(np.log(prices), axis=0)        # (T-1, A)
    mean_step = logret.mean(axis=0)
    if estimator == "sample":
        cov_step = np.cov(logret, rowvar=False, ddof=1)
    elif estimator == "lw":
        cov_step, _ = ledoit_wolf_shrinkage(logret)
    elif estimator == "ewma":
        cov_step = ewma_cov(logret, ewma_lambda)
    else:
        raise ValueError(
            f"estimator must be 'sample', 'lw' or 'ewma', got {estimator!r}")
    cov_step = np.atleast_2d(cov_step)
    a = cov_step.shape[0]
    chol = np.linalg.cholesky(cov_step + jitter * np.eye(a))
    return GBMParams(s0=prices[-1].copy(), mean_step=mean_step, chol_step=chol)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "antithetic", "dtype",
                                   "t_df"))
def simulate_log_paths(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
    dtype=jnp.float32,
    t_df: float | None = None,
) -> Array:
    """Full path simulation → cumulative log returns (n_paths, n_steps, A).

    ``lax.scan`` over steps; z is drawn inside the scan with a per-step folded key
    so no (steps, paths, A) noise tensor ever materializes in HBM. The time axis is
    the sequential dimension (SURVEY.md §5: the honest "sequence parallelism" of
    this workload stays on-chip; the scaling axis across chips is paths).

    ``t_df`` swaps the shocks for UNIT-VARIANCE Student-t draws (the
    :func:`terminal_log_returns_t` convention: polar-transform t scaled by
    1/sqrt(df/(df-2)) so the per-step covariance stays ``L L'`` exactly —
    only tail thickness changes).
    """
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T            # pre-transpose: z @ L^T
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    if t_df is not None:
        scale = 1.0 / jnp.sqrt(jnp.asarray(t_df / (t_df - 2.0), dtype))

    def step(carry, t):
        logs = carry
        zk = jax.random.fold_in(key, t)
        if t_df is not None:
            z = _student_t_polar(zk, t_df, (half, a), dtype) * scale
        else:
            z = jax.random.normal(zk, (half, a), dtype)
        if antithetic:
            z = jnp.concatenate([z, -z], axis=0)
        logs = logs + m + z @ lt
        return logs, logs

    init = jnp.zeros((half * 2 if antithetic else n_paths, a), dtype)
    _, path = jax.lax.scan(step, init, jnp.arange(n_steps))
    return jnp.moveaxis(path, 0, 1)                 # (paths, steps, A)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "antithetic", "dtype"))
def terminal_log_returns(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
    dtype=jnp.float32,
) -> Array:
    """Terminal cumulative log returns (n_paths, A) via the full step recursion.

    Same draws as :func:`simulate_log_paths` but carries only the running log
    price — O(paths x A) memory regardless of horizon. This is the benchmark
    workload (path-steps/sec counts paths x steps).
    """
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths

    def step(carry, t):
        zk = jax.random.fold_in(key, t)
        z = jax.random.normal(zk, (half, a), dtype)
        if antithetic:
            z = jnp.concatenate([z, -z], axis=0)
        return carry + m + z @ lt, None

    init = jnp.zeros((half * 2 if antithetic else n_paths, a), dtype)
    out, _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return out


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "antithetic", "dtype"))
def terminal_log_returns_exact(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
    dtype=jnp.float32,
) -> Array:
    """Exact terminal sampler: one draw per path.

    The terminal log return of GBM is exactly Gaussian —
    ``N(n m, n L L')`` — so terminal-only risk stats need a single
    (paths, A) draw scaled by sqrt(n_steps). Used as the QMC base (dims = A) and
    as a distributional cross-check of the step recursion.
    """
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    z = jax.random.normal(key, (half, a), dtype)
    if antithetic:
        z = jnp.concatenate([z, -z], axis=0)
    scale = jnp.sqrt(jnp.asarray(n_steps, dtype))
    return n_steps * m + scale * (z @ lt)


def portfolio_terminal_returns(terminal_log: Array, weights: Array) -> Array:
    """Portfolio simple return per path: sum_a w_a (exp(logR_a) - 1).

    weights (A,) or (W, A) → returns (paths,) or (paths, W); the (paths, A) x
    (A, W) contraction is the matmul-heavy op when scoring many candidate portfolios
    against simulated paths.
    """
    gross = jnp.exp(jnp.asarray(terminal_log)) - 1.0
    w = jnp.asarray(weights, gross.dtype)
    if w.ndim == 1:
        return gross @ w
    return gross @ w.T


# ---- Student-t innovations (fat tails) -----------------------------------------
#
# Crypto return series are strongly leptokurtic; normal GBM understates tail
# risk. These variants keep the same drift/Cholesky structure but draw the
# per-step shocks from a unit-variance Student-t: z = t_nu / sqrt(nu/(nu-2)).
# The degrees of freedom fit by method of moments on the pooled per-step
# standardized log returns (excess kurtosis of t_nu is 6/(nu-4)).


def estimate_t_dof(prices: np.ndarray, min_dof: float = 4.5,
                   max_dof: float = 50.0) -> float:
    """Method-of-moments Student-t degrees of freedom from log returns.

    Pools the per-asset standardized log returns (one nu for the universe —
    the innovations share a tail index like they share the Cholesky copula),
    matches excess kurtosis 6/(nu-4), and clamps to [min_dof, max_dof]:
    below ~4.5 the kurtosis estimator itself is unstable, above 50 the t is
    indistinguishable from normal at these sample sizes.
    """
    prices = np.asarray(prices, np.float64)
    logret = np.diff(np.log(prices), axis=0)
    z = (logret - logret.mean(axis=0)) / logret.std(axis=0, ddof=1)
    kurt = float(np.mean(z**4))
    excess = max(kurt - 3.0, 1e-9)
    nu = 4.0 + 6.0 / excess
    return float(np.clip(nu, min_dof, max_dof))


def _student_t_polar(key: Array, df: float, shape, dtype) -> Array:
    """Exact Student-t draws via Bailey's polar transform:
    T = sqrt(df * (U1^(-2/df) - 1)) * cos(2 pi U2) ~ t_df.

    Pure elementwise (ln/exp/sqrt/cos) — ``jax.random.t``'s gamma rejection
    sampler is a data-dependent loop per draw (the dirichlet lesson again). One t
    per two uniforms; quantile parity vs jax.random.t pinned in tests through
    the 0.1% tails.
    """
    k1, k2 = jax.random.split(key)
    eps = 0.5 / (1 << 25)
    u1 = jax.random.uniform(k1, shape, dtype, eps, 1.0)
    u2 = jax.random.uniform(k2, shape, dtype)
    r = jnp.sqrt(df * (u1 ** (-2.0 / df) - 1.0))
    return r * jnp.cos(2.0 * math.pi * u2)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "antithetic", "dtype"))
def terminal_log_returns_t(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    df: float,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
    dtype=jnp.float32,
) -> Array:
    """Terminal cumulative log returns with unit-variance Student-t shocks.

    Same step recursion and stream structure as :func:`terminal_log_returns`
    (fold_in per step; antithetic mirrors the draws), with
    ``z = t_df / sqrt(df/(df-2))`` so the per-step covariance still equals
    ``L L'`` exactly — only tail thickness changes. Draws use the polar
    transform (:func:`_student_t_polar`), not the rejection sampler.
    """
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    scale = 1.0 / jnp.sqrt(jnp.asarray(df / (df - 2.0), dtype))

    def step(carry, t):
        zk = jax.random.fold_in(key, t)
        z = _student_t_polar(zk, df, (half, a), dtype) * scale
        if antithetic:
            z = jnp.concatenate([z, -z], axis=0)
        return carry + m + z @ lt, None

    init = jnp.zeros((half * 2 if antithetic else n_paths, a), dtype)
    out, _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return out
