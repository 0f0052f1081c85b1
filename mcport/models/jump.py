"""Merton jump-diffusion with systemic (common) jumps.

Reference anchor: the reference's only tail-risk estimator is the historical
percentile of the realized return series (/root/reference/app.py:258-263) and
its "Monte Carlo" never simulates paths (SURVEY.md §2 "GBM is implied, not
implemented"); this module extends the BASELINE.json:5 correlated-GBM mandate
with the standard crash-risk companion model, calibrated from the same
ingested price matrix the reference's moments use (app.py:679-680).

Model-family extension beyond GBM/Student-t/GARCH/bootstrap: crypto drawdowns
are driven by market-wide crash events that hit every asset at once. The model
adds a compound-Poisson SYSTEMIC jump to the correlated diffusion:

    terminal log return_a = n*m_a + sqrt(n) * (L z)_a            (diffusion)
                          + N * muJ_a + sqrt(N) * sigJ_a * u     (jumps)

where N ~ Poisson(lambda_step * n) counts jump events over the horizon and a
single standard normal ``u`` per path scales every asset's jump size — jump
events are perfectly correlated across assets (asset-specific mean/vol,
common shock), which is the crash co-movement the diffusion correlation alone
cannot produce. Conditional on N the jump sum is exactly Gaussian, so the
terminal sampler is exact (no per-step loop needed for terminal risk).

Calibration (``estimate_merton_common``) is the standard threshold method:
flag systemic-jump steps where the cross-sectional median |z-score| exceeds a
threshold, estimate (lambda, muJ, sigJ) from those steps, and re-estimate the
diffusion moments from the remaining steps so diffusion vol is not inflated
by jumps.

Device mapping: one (paths, A) Gaussian draw + two per-path scalars; everything
is a fixed-shape jnp program sharing the sketch/moment reducers.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.config import SketchConfig
from mcport.models.gbm import GBMParams
from mcport.ops.quantile import histogram, sketch_var_cvar

__all__ = [
    "MertonParams",
    "estimate_merton_common",
    "merton_terminal_returns",
    "merton_path_stats",
    "merton_risk",
    "MertonRisk",
    "default_merton_sketch",
]


@dataclass(frozen=True)
class MertonParams:
    """Diffusion (per-step) + systemic-jump parameters."""

    diffusion: GBMParams        # per-step m, L estimated on non-jump steps
    jump_rate: float            # lambda per step (P[jump event] per period)
    jump_mean: np.ndarray       # (A,) mean log-jump size per asset
    jump_vol: np.ndarray        # (A,) jump-size vol per asset

    @property
    def n_assets(self) -> int:
        return self.diffusion.n_assets


def estimate_merton_common(
    prices: np.ndarray, threshold: float = 3.0, jitter: float = 1e-12
) -> MertonParams:
    """Threshold calibration of the common-jump model from a (T, A) price matrix.

    A step is a systemic jump event when the cross-sectional MEDIAN |z-score|
    of the assets' log returns exceeds ``threshold`` (a single asset spiking is
    idiosyncratic; the median requires the market to move together). Diffusion
    moments re-fit on the non-jump steps; jump mean/vol per asset come from the
    jump-step residuals vs the diffusion mean. With no detected jumps the model
    degrades to plain GBM (jump_rate = 0).
    """
    from mcport.models.gbm import estimate_gbm

    prices = np.asarray(prices, np.float64)
    logret = np.diff(np.log(prices), axis=0)            # (T-1, A)
    mu0 = logret.mean(axis=0)
    sd0 = logret.std(axis=0, ddof=1)
    z = (logret - mu0) / np.maximum(sd0, 1e-12)
    jump_step = np.median(np.abs(z), axis=1) > threshold

    n_jump = int(jump_step.sum())
    t_eff = logret.shape[0]
    if n_jump == 0:
        diff = estimate_gbm(prices, jitter)
        a = diff.n_assets
        return MertonParams(diff, 0.0, np.zeros(a), np.zeros(a))

    calm = logret[~jump_step]
    if calm.shape[0] < 3:
        raise ValueError(
            f"threshold {threshold} flags {n_jump}/{t_eff} steps as jumps, "
            f"leaving {calm.shape[0]} calm steps — too few to estimate the "
            "diffusion (need >= 3); raise the threshold"
        )
    mean_step = calm.mean(axis=0)
    cov_step = np.atleast_2d(np.cov(calm, rowvar=False, ddof=1))
    a = cov_step.shape[0]
    chol = np.linalg.cholesky(cov_step + jitter * np.eye(a))
    diff = GBMParams(s0=prices[-1].copy(), mean_step=mean_step, chol_step=chol)

    resid = logret[jump_step] - mean_step               # jump-step excess moves
    jump_mean = resid.mean(axis=0)
    jump_vol = resid.std(axis=0, ddof=1) if n_jump > 1 else np.zeros(a)
    return MertonParams(diff, n_jump / t_eff, jump_mean, jump_vol)


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype", "return_jumps"))
def merton_terminal_returns(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    jump_rate: float,
    jump_mean: Array,
    jump_vol: Array,
    n_paths: int,
    n_steps: int,
    dtype=jnp.float32,
    return_jumps: bool = False,
):
    """(n_paths, A) terminal LOG returns of the common-jump Merton model
    (with ``return_jumps=True``, also the per-path Poisson event counts —
    callers must consume them from here, never re-derive the stream).

    Exact terminal sampler: diffusion is N(n m, n LL'); conditional on the
    Poisson event count N the jump sum is N(N muJ, N sigJ sigJ') (rank-one —
    one common shock per path).
    """
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    mu_j = jnp.asarray(jump_mean, dtype)
    sig_j = jnp.asarray(jump_vol, dtype)
    a = m.shape[-1]
    k_z, k_n, k_u = jax.random.split(key, 3)
    z = jax.random.normal(k_z, (n_paths, a), dtype)
    lam = jnp.asarray(jump_rate * n_steps, jnp.float32)
    n_jumps = jax.random.poisson(k_n, lam, (n_paths,)).astype(dtype)
    u = jax.random.normal(k_u, (n_paths,), dtype)
    scale = jnp.sqrt(jnp.asarray(n_steps, dtype))
    diffusion = n_steps * m + scale * (z @ lt)
    jumps = n_jumps[:, None] * mu_j + jnp.sqrt(n_jumps)[:, None] * u[:, None] * sig_j
    term = diffusion + jumps
    if return_jumps:
        return term, n_jumps
    return term


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def merton_path_stats(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    jump_rate: float,
    jump_mean: Array,
    jump_vol: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    dtype=jnp.float32,
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of W
    candidate portfolios over common-jump Merton PATHS — the lax reference
    for :func:`mcport.ops.pallas_jump.pallas_merton_path_stats` (same model,
    independent stream).

    Per-step discretization of the compound-Poisson jump clock: each step is
    a systemic jump event with probability ``jump_rate`` (Bernoulli — the
    event count over n steps is Binomial(n, lambda) vs the exact terminal
    sampler's Poisson(n·lambda); identical to O(lambda^2) per step, and the
    per-step form is what a path engine needs). On a jump step every asset
    moves by ``muJ_a + sigJ_a·u`` with one common normal ``u`` per (path,
    step) — the crash co-movement of :func:`merton_terminal_returns`, step
    by step. Candidates compound the per-period rebalanced wealth
    ``V_{t+1} = V_t · (w'exp(x_t))`` with running peak/drawdown carries;
    ``hedge_args = (s0, type_id, strike, premium, qty)`` switches to hedged
    per-period settlement against the simulated price path
    ``p_{t+1} = p_t·exp(x_t)``."""
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    mu_j = jnp.asarray(jump_mean, dtype)
    sig_j = jnp.asarray(jump_vol, dtype)
    a = m.shape[-1]
    w = jnp.asarray(weights, dtype)
    if w.ndim == 1:
        w = w[None, :]
    w_t = w.T
    lam = jnp.asarray(jump_rate, dtype)
    hedged = hedge_args is not None
    if hedged:
        s0, ht, hk, hp, hq = hedge_args
        p0 = jnp.broadcast_to(jnp.asarray(s0, dtype), (n_paths, a))
    else:
        p0 = jnp.ones((n_paths, a), dtype)

    def step(carry, t):
        p, v, peak, dd = carry
        kt = jax.random.fold_in(key, t)
        k_z, k_b, k_u = jax.random.split(kt, 3)
        z = jax.random.normal(k_z, (n_paths, a), dtype)
        event = (jax.random.uniform(k_b, (n_paths,)) < lam).astype(dtype)
        u = jax.random.normal(k_u, (n_paths,), dtype)
        x = m + z @ lt + event[:, None] * (mu_j + sig_j * u[:, None])
        g = jnp.exp(x)                                       # (n, A) gross
        if hedged:
            from mcport.options.hedged import hedged_step_returns

            p_new = p * g
            r_score = hedged_step_returns(p, p_new, ht, hk, hp, hq)
            p = p_new
            f = 1.0 + r_score @ w_t
        else:
            f = g @ w_t                                      # (n, W) w'exp(x)
        v = v * f
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        return (p, v, peak, dd), None

    n_cand = w.shape[0]
    init = (p0,
            jnp.ones((n_paths, n_cand), dtype),
            jnp.ones((n_paths, n_cand), dtype),
            jnp.zeros((n_paths, n_cand), dtype))
    (_, v, _, dd), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return (v - 1.0).T, dd.T


from typing import NamedTuple  # noqa: E402  (single consumer below)


class MertonRisk(NamedTuple):
    var: Array
    cvar: Array
    port_mean: Array
    mean: Array          # (A,) mean terminal log return
    jump_frac: Array     # () fraction of paths with >= 1 jump event
    hist: Array


def default_merton_sketch(params: MertonParams, n_steps: int) -> SketchConfig:
    """Covering sketch: GBM-derived range widened by the worst plausible
    compound-Poisson jump contribution (10-sigma on a 10-sigma-high count)."""
    from mcport.ops.quantile import auto_sketch

    lam = max(params.jump_rate * n_steps, 1e-12)
    n_hi = lam + 10.0 * np.sqrt(lam) + 10.0
    jump_lo = float(np.min(n_hi * params.jump_mean
                           - 10.0 * np.sqrt(n_hi) * params.jump_vol))
    jump_hi = float(np.max(n_hi * params.jump_mean
                           + 10.0 * np.sqrt(n_hi) * params.jump_vol))
    base = auto_sketch(params.diffusion.mean_step, params.diffusion.chol_step,
                       n_steps)
    return SketchConfig(
        n_bins=base.n_bins,
        lo=base.lo + min(jump_lo, 0.0),
        hi=base.hi + max(jump_hi, 0.0),
        space="log1p",
    )


def merton_risk(
    key: Array,
    params: MertonParams,
    weights: np.ndarray,
    n_paths: int = 262_144,
    n_steps: int = 52,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    dtype=jnp.float32,
) -> MertonRisk:
    """Portfolio tail risk under the common-jump model (sketch-reduced)."""
    if sketch is None:
        sketch = default_merton_sketch(params, n_steps)
    term, n_jumps = merton_terminal_returns(
        key, params.diffusion.mean_step, params.diffusion.chol_step,
        params.jump_rate, params.jump_mean, params.jump_vol,
        n_paths, n_steps, dtype, return_jumps=True,
    )
    gross = jnp.exp(term) - 1.0
    port = gross @ jnp.asarray(weights, dtype)
    counts = histogram(port, sketch)
    v, c = sketch_var_cvar(counts, alpha, sketch)
    return MertonRisk(v, c, port.mean(), term.mean(axis=0),
                      (n_jumps > 0).mean(), counts)
