"""Mesh-sharded Monte-Carlo risk engine (shard_map + XLA collectives).

BASELINE.json:5: "paths shard across chips with psum/all-gather over ICI so
variance shrinks linearly with pod size". Design:

- every device simulates its own slice of the path space from a **counter-derived
  seed** (``fold_in(key, axis_index)`` / ``seed + device_idx * stride``) — zero
  input communication;
- exact global moments reduce with ``psum`` over the MomentState accumulators
  (associative adds — the mathematically exact reduction);
- tail quantiles reduce by ``psum`` of fixed-grid histogram counts
  (:mod:`mcport.ops.quantile`), so 16M-path VaR/CVaR crosses devices as one
  (n_bins,) vector instead of 16M returns (the all-gather-free sketch path);
- the candidate-portfolio search shards the candidate axis the same way and
  resolves the global argmax with one tiny ``all_gather`` of per-device bests.

Everything works identically on the CPU 8-device emulation used in CI
(SURVEY.md §4) and on a real pod; only ``use_pallas`` flips the path generator.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mcport.config import SketchConfig
from mcport.models.gbm import portfolio_terminal_returns, terminal_log_returns
from mcport.ops.quantile import (
    MomentState,
    auto_sketch,
    finalize_moments,
    histogram,
    init_moments,
    sketch_var_cvar,
    update_moments,
)

from mcport.seeding import SEED_STRIDE  # re-exported; historical home

__all__ = ["ShardedRisk", "ShardedSearchResult", "SEARCH_OBJECTIVES", "SEED_STRIDE",
           "sharded_gbm_risk", "sharded_weight_search"]


class ShardedRisk(NamedTuple):
    """Globally-reduced risk bundle (identical replica on every device)."""

    mean: Array       # (A,) terminal log-return mean (exact psum reduction)
    cov: Array        # (A, A) terminal log-return covariance (exact)
    hist: Array       # (n_bins,) global portfolio-return histogram
    var: Array        # () VaR at alpha from the sketch
    cvar: Array       # () CVaR at alpha from the sketch
    port_mean: Array  # () exact mean portfolio simple return


def _local_terminal(seed, mean_step, chol_step, n_local, n_steps, use_pallas,
                    antithetic, t_df=None, bm="poly"):
    if use_pallas:
        from mcport.ops.pallas_gbm import pallas_terminal_log_returns

        return pallas_terminal_log_returns(
            seed, mean_step, chol_step, n_local, n_steps, antithetic=antithetic,
            t_df=t_df, bm=bm,
        )
    key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    if t_df is not None:
        from mcport.models.gbm import terminal_log_returns_t

        return terminal_log_returns_t(
            key, mean_step, chol_step, t_df, n_local, n_steps, antithetic=antithetic
        )
    return terminal_log_returns(
        key, mean_step, chol_step, n_local, n_steps, antithetic=antithetic
    )


def sharded_gbm_risk(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    use_pallas: bool = False,
    antithetic: bool = False,
    axis: str = "paths",
    t_df: float | None = None,
) -> ShardedRisk:
    """GBM tail risk over a mesh: n_paths total, split along ``axis``.

    All inputs are replicated (tiny); the path space is partitioned by seed
    arithmetic, not by sharded inputs — the only cross-device traffic is the
    psum of (A + A^2 + n_bins + 2) floats. ``sketch=None`` derives the adaptive
    log1p sketch from the parameters (identical on every device: the config is a
    static jit argument resolved on host before tracing). ``t_df`` switches to
    unit-variance Student-t innovations (fat tails; polar transform).
    """
    if sketch is None:
        sketch = auto_sketch(mean_step, chol_step, n_steps, t_dof=t_df)
    return _sharded_gbm_risk(
        seed, mean_step, chol_step, weights, n_paths, n_steps, mesh,
        alpha, sketch, use_pallas, antithetic, axis, t_df,
    )


@partial(
    jax.jit,
    static_argnames=(
        "n_paths", "n_steps", "mesh", "alpha", "sketch", "use_pallas",
        "antithetic", "axis", "t_df",
    ),
)
def _sharded_gbm_risk(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float,
    sketch: SketchConfig,
    use_pallas: bool,
    antithetic: bool,
    axis: str,
    t_df: float | None = None,
) -> ShardedRisk:
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    a = mean_step.shape[-1]

    def local(seed, mean_step, chol_step, weights):
        idx = jax.lax.axis_index(axis)
        dev_seed = seed + idx * SEED_STRIDE
        term = _local_terminal(
            dev_seed, mean_step, chol_step, n_local, n_steps, use_pallas,
            antithetic, t_df
        )
        port = portfolio_terminal_returns(term, weights)
        # drift centering (identical on every device — replicated params), so the
        # covariance finalization is cancellation-free; see ops.quantile.
        shift = n_steps * mean_step
        moments = update_moments(init_moments(a, term.dtype), term, shift=shift)
        counts = histogram(port, sketch)
        psum = lambda x: jax.lax.psum(x, axis)
        g_moments = MomentState(*map(psum, moments))
        g_counts = psum(counts)
        g_port_sum = psum(port.sum())
        mean, cov = finalize_moments(g_moments, shift=shift)
        v, c = sketch_var_cvar(g_counts, alpha, sketch)
        return ShardedRisk(mean, cov, g_counts, v, c, g_port_sum / n_paths)

    spec_in = (P(), P(), P(), P())
    spec_out = ShardedRisk(P(), P(), P(), P(), P(), P())
    # check_vma off: outputs are replicated by construction (psum results); the
    # static varying-axis inference can't see through the seed-derived streams.
    fn = shard_map(local, mesh=mesh, in_specs=spec_in, out_specs=spec_out, check_vma=False)
    return fn(
        jnp.asarray(seed, jnp.int32),
        jnp.asarray(mean_step),
        jnp.asarray(chol_step),
        jnp.asarray(weights),
    )


class ShardedSearchResult(NamedTuple):
    """Globally-resolved weight-search optimum (replicated on every device)."""

    weights: Array   # (A,) — NaN when n_valid == 0 (the Equal-Weight/no-valid guard)
    metric: Array    # () raw-form metric of the winner; -inf when n_valid == 0
    n_valid: Array   # () global count of constraint-respecting candidates


SEARCH_OBJECTIVES = ("sharpe", "var_95", "cvar_95", "target_risk", "equal_weight")


@partial(
    jax.jit,
    static_argnames=("n_candidates", "mesh", "alpha", "objective", "axis"),
)
def sharded_weight_search(
    key: Array,
    returns: Array,
    mean_ann: Array,
    cov_ann: Array,
    n_candidates: int,
    mesh: Mesh,
    min_weights: Array,
    max_weights: Array,
    risk_free: float = 0.0,
    alpha: float = 0.95,
    objective: str = "sharpe",
    target_risk: float = 0.30,
    axis: str = "cand",
) -> ShardedSearchResult:
    """Candidate-axis-sharded weight search → :class:`ShardedSearchResult`.

    Each device samples and scores ``n_candidates / n_dev`` constrained Dirichlet
    candidates locally (the (B, A) x (A, T) series matmul stays on-device), then a
    single ``all_gather`` of per-device winners resolves the global optimum — the
    1M-candidate search of BASELINE.json:9 moves no candidate clouds between devices.

    Full objective parity with the single-chip engine (weight_search.py):

    - ``sharpe`` / ``var_95`` / ``cvar_95`` — argmax (var/cvar raw-form maximize ==
      the reference's argmin of the stored negated metric, app.py:673-674);
    - ``target_risk`` — max return among candidates with std <= target; when no
      candidate is feasible anywhere on the mesh, the candidate nearest the target
      risk (the single-chip fallback of weight_search._select_optimum);
    - ``equal_weight`` — evaluates the replicated 1/A portfolio (nothing to shard);
      exists so the mesh path covers all six reference methods.

    When no candidate on any device satisfies the bounds, ``n_valid == 0`` and the
    result carries NaN weights / -inf metric instead of the reference's IndexError
    (SURVEY.md §2 Equal-Weight guard).
    """
    from mcport.engine.weight_search import evaluate_portfolios
    from mcport.ops.dirichlet import constraint_mask, sample_constrained_weights

    if objective not in SEARCH_OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; expected one of {SEARCH_OBJECTIVES}"
        )
    n_dev = mesh.shape[axis]
    if n_candidates % n_dev:
        raise ValueError(f"n_candidates {n_candidates} not divisible by axis {n_dev}")
    n_local = n_candidates // n_dev

    def local(key, returns, mean_ann, cov_ann, min_w, max_w):
        idx = jax.lax.axis_index(axis)
        if objective == "equal_weight":
            a = mean_ann.shape[-1]
            w = jnp.full((1, a), 1.0 / a, returns.dtype)
            valid = constraint_mask(w, min_w, max_w)
        else:
            k = jax.random.fold_in(key, idx)
            w, valid = sample_constrained_weights(k, n_local, min_w, max_w)
            w = w.astype(returns.dtype)
        ev = evaluate_portfolios(w, returns, mean_ann, cov_ann, risk_free, alpha)
        neg_inf = jnp.asarray(-jnp.inf, ev.ret.dtype)
        nan = jnp.asarray(jnp.nan, w.dtype)
        psum = lambda x: jax.lax.psum(x, axis)
        n_valid = psum(valid.sum().astype(jnp.int32))

        def pick(score, value):
            """Global argmax of ``score``; returns (weights, value) of the winner."""
            i = jnp.argmax(score)
            g_s = jax.lax.all_gather(score[i], axis)       # (n_dev,)
            g_v = jax.lax.all_gather(value[i], axis)
            g_w = jax.lax.all_gather(w[i], axis)           # (n_dev, A)
            g = jnp.argmax(g_s)
            return g_w[g], g_s[g], g_v[g]

        if objective == "target_risk":
            feasible = valid & (ev.std <= target_risk)
            fw, fs, fr = pick(jnp.where(feasible, ev.ret, neg_inf), ev.ret)
            nw, _, nr = pick(jnp.where(valid, -jnp.abs(ev.std - target_risk), neg_inf),
                             ev.ret)
            any_feas = fs > neg_inf
            best_w = jnp.where(any_feas, fw, nw)
            best_m = jnp.where(any_feas, fr, nr)
        else:
            metric = {"sharpe": ev.sharpe, "var_95": ev.var_95, "cvar_95": ev.cvar_95,
                      "equal_weight": ev.sharpe}[objective]
            best_w, best_m, _ = pick(jnp.where(valid, metric, neg_inf), metric)

        ok = n_valid > 0
        return ShardedSearchResult(
            jnp.where(ok, best_w, nan),
            jnp.where(ok, best_m, -jnp.inf),
            n_valid,
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=ShardedSearchResult(P(), P(), P()),
        check_vma=False,  # replicated by the final all_gather+argmax
    )
    return fn(
        key,
        jnp.asarray(returns),
        jnp.asarray(mean_ann),
        jnp.asarray(cov_ann),
        jnp.asarray(min_weights),
        jnp.asarray(max_weights),
    )
