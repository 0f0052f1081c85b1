"""Stationary block-bootstrap Monte Carlo over historical joint returns.

Model-family extension (round 2): the reference computes *historical* VaR from
the one realized return path (app.py:258-263) and mcport's GBM/CCC-GARCH
engines simulate *parametric* paths. The block bootstrap sits between them —
distribution-free forward simulation that preserves the empirical joint
cross-asset distribution exactly (each resampled time step is one real (A,)
return row) and short-range serial dependence (expected block length ``1/p``,
Politis-Romano stationary bootstrap with circular wrap).

Device mapping: paths are the vector axis; time is a ``lax.scan`` whose carry
is (row index per path, compounded per-asset gross return). The per-step state
update is index arithmetic + one row gather from the tiny (T, A) history
(cache-resident) — no Gaussian machinery at all. Draws are Threefry counter-based per
(seed, step), so paths are reproducible and shardable by the same seed
arithmetic as the GBM engines.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.config import SketchConfig
from mcport.seeding import SEED_STRIDE
from mcport.ops.quantile import histogram, sketch_var_cvar

__all__ = ["BootstrapRisk", "bootstrap_terminal_returns",
           "bootstrap_path_stats", "bootstrap_risk"]


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def bootstrap_terminal_returns(
    key: Array,
    returns: Array,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    dtype=jnp.float32,
) -> Array:
    """(n_paths, A) terminal simple returns of stationary-bootstrap paths.

    ``returns`` is the (T, A) historical per-period simple-return matrix (the
    reference's tab-2 assembly). Each path compounds ``n_steps`` resampled
    rows; at every step the row index either advances circularly (prob
    ``1 - p_restart``) or jumps to a fresh uniform start — expected block
    length ``1/p_restart``. ``p_restart=1`` is the iid bootstrap.
    """
    r = jnp.asarray(returns, dtype)
    t_len, a = r.shape

    k_start, k_scan = jax.random.split(jax.random.fold_in(key, 0x626F6F74))
    idx0 = jax.random.randint(k_start, (n_paths,), 0, t_len)

    def step(carry, t):
        idx, gross = carry
        kt = jax.random.fold_in(k_scan, t)
        k_u, k_j = jax.random.split(kt)
        restart = jax.random.uniform(k_u, (n_paths,)) < p_restart
        jump = jax.random.randint(k_j, (n_paths,), 0, t_len)
        idx = jnp.where(restart, jump, (idx + 1) % t_len)
        gross = gross * (1.0 + r[idx])          # (n_paths, A) joint row gather
        return (idx, gross), None

    init = (idx0, jnp.ones((n_paths, a), dtype))
    (_, gross), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return gross - 1.0


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def bootstrap_path_stats(
    key: Array,
    returns: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    dtype=jnp.float32,
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of W
    candidate portfolios over stationary-bootstrap paths — the lax reference
    for :func:`mcport.ops.pallas_bootstrap.pallas_bootstrap_path_stats`
    (same model, independent stream).

    Same resampling recursion (and the SAME draw stream: identical
    (key, step) Threefry addressing) as :func:`bootstrap_terminal_returns`;
    candidates compound the per-period rebalanced wealth
    ``V_{t+1} = V_t (1 + w'r_t)`` with running peak/drawdown carries.
    ``hedge_args = (s0, type_id, strike, premium, qty)`` switches to hedged
    per-period settlement against the resampled price path
    ``p_{t+1} = p_t (1 + r_t)``
    (:func:`mcport.options.hedged.hedged_step_returns`)."""
    r = jnp.asarray(returns, dtype)
    t_len, a = r.shape
    w = jnp.asarray(weights, dtype)
    if w.ndim == 1:
        w = w[None, :]
    w_t = w.T
    hedged = hedge_args is not None
    if hedged:
        s0, ht, hk, hp, hq = hedge_args
        p0 = jnp.broadcast_to(jnp.asarray(s0, dtype), (n_paths, a))
    else:
        p0 = jnp.ones((n_paths, a), dtype)

    k_start, k_scan = jax.random.split(jax.random.fold_in(key, 0x626F6F74))
    idx0 = jax.random.randint(k_start, (n_paths,), 0, t_len)

    def step(carry, t):
        idx, p, v, peak, dd = carry
        kt = jax.random.fold_in(k_scan, t)
        k_u, k_j = jax.random.split(kt)
        restart = jax.random.uniform(k_u, (n_paths,)) < p_restart
        jump = jax.random.randint(k_j, (n_paths,), 0, t_len)
        idx = jnp.where(restart, jump, (idx + 1) % t_len)
        r_t = r[idx]                                        # (n_paths, A)
        if hedged:
            from mcport.options.hedged import hedged_step_returns

            p_new = p * (1.0 + r_t)
            r_score = hedged_step_returns(p, p_new, ht, hk, hp, hq)
            p = p_new
        else:
            r_score = r_t
        v = v * (1.0 + r_score @ w_t)                       # (n, W)
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        return (idx, p, v, peak, dd), None

    n_cand = w.shape[0]
    init = (idx0, p0,
            jnp.ones((n_paths, n_cand), dtype),
            jnp.ones((n_paths, n_cand), dtype),
            jnp.zeros((n_paths, n_cand), dtype))
    (_, _, v, _, dd), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return (v - 1.0).T, dd.T


class BootstrapRisk(NamedTuple):
    """Tail-risk bundle of a bootstrap run (same shape as the GBM engines')."""

    var: Array        # () portfolio VaR at alpha (simple-return units)
    cvar: Array       # ()
    port_mean: Array  # ()
    mean: Array       # (A,) per-asset mean terminal simple return
    hist: Array       # (n_bins,) portfolio-return histogram


def _auto_sketch_from_history(returns: np.ndarray, n_steps: int,
                              n_bins: int = 8192) -> SketchConfig:
    """Covering log1p-range from the history itself: the most extreme possible
    path compounds the best/worst historical row every step."""
    r = np.asarray(returns, np.float64)
    worst = np.log1p(np.maximum(r.min(), -0.9999))
    best = np.log1p(r.max())
    lo = n_steps * min(worst, 0.0)
    hi = n_steps * max(best, 0.0)
    pad = 1e-6 * max(1.0, hi - lo)
    return SketchConfig(n_bins=n_bins, lo=float(lo - pad), hi=float(hi + pad),
                        space="log1p")


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "p_restart", "alpha",
                                   "sketch", "dtype"))
def _bootstrap_risk_impl(
    key, returns, weights, n_paths, n_steps, p_restart, alpha, sketch, dtype
):
    term = bootstrap_terminal_returns(key, returns, n_paths, n_steps,
                                      p_restart, dtype)
    port = term @ jnp.asarray(weights, dtype)
    counts = histogram(port, sketch)
    v, c = sketch_var_cvar(counts, alpha, sketch)
    return BootstrapRisk(v, c, port.mean(), term.mean(axis=0), counts)


def bootstrap_risk(
    key: Array,
    returns: np.ndarray,
    weights: np.ndarray,
    n_paths: int = 100_000,
    n_steps: int = 52,
    p_restart: float = 0.2,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    dtype=jnp.float32,
) -> BootstrapRisk:
    """Distribution-free portfolio tail risk from resampled historical paths.

    ``sketch=None`` derives a guaranteed-covering log1p range from the history
    (the compounded best/worst rows bound every possible path).
    """
    if sketch is None:
        sketch = _auto_sketch_from_history(returns, n_steps)
    return _bootstrap_risk_impl(
        key, jnp.asarray(returns), jnp.asarray(weights), n_paths, n_steps,
        p_restart, alpha, sketch, dtype,
    )
