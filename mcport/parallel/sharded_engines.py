"""Mesh-sharded variants of the path-risk and simulated-frontier engines.

Completes the distributed story: every compute engine in mcport has a shard_map
form whose cross-device traffic is a reduction, never a gather of paths.

- :func:`sharded_path_risk` — paths axis: each device evolves its own
  counter-seeded slice of full paths (drawdown tracking included) and the two
  histogram sketches psum.
- :func:`sharded_simulated_frontier` — candidate axis: every device scores its
  own candidate shard against an identical simulated terminal set (same path
  seed on all devices — replicated by construction, zero communication), then
  one all_gather of per-device winners resolves the argmax.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mcport.config import SketchConfig
from mcport.engine.path_risk import DD_SKETCH, PathRiskReport, _lax_path_stats
from mcport.models.gbm import terminal_log_returns
from mcport.ops.dirichlet import sample_constrained_weights
from mcport.ops.quantile import histogram, sketch_quantile, sketch_var_cvar
from mcport.seeding import SEED_STRIDE

__all__ = ["sharded_path_risk", "sharded_family_path_risk",
           "sharded_family_drawdown_frontier",
           "sharded_family_drawdown_frontier_2d",
           "sharded_simulated_frontier",
           "sharded_simulated_frontier_2d", "sharded_bootstrap_risk",
           "sharded_drawdown_frontier", "sharded_garch_risk",
           "sharded_merton_risk", "sharded_importance_tail",
           "sharded_dcc_risk", "sharded_cvar_attribution",
           "sharded_hedged_gbm_risk", "sharded_american_value"]


def sharded_hedged_gbm_risk(
    seed,
    params,
    weights,
    hedge,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
):
    """Hedged terminal tail risk over a paths mesh.

    Each device draws its counter-seeded slice of GBM terminals, settles the
    option legs at intrinsic value (mcport.options.hedged terminal
    composition), and the only cross-device traffic is the psum of the
    portfolio histogram + sum — same communication shape as
    :func:`mcport.parallel.sharded_mc.sharded_gbm_risk`. Returns
    (var, cvar, port_mean), replicated.
    """
    from mcport.options.hedged import auto_hedged_sketch, hedged_terminal_returns

    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    if sketch is None:
        w_np = np.asarray(weights, np.float64)
        sketch = auto_hedged_sketch(
            params, n_steps, hedge,
            weights=w_np if (w_np >= 0).all() else None)

    def local(seed, mean_step, chol_step, s0, w, h_t, h_k, h_p, h_q):
        idx = jax.lax.axis_index(axis)
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed + idx * SEED_STRIDE)
        term = terminal_log_returns(key, mean_step, chol_step, n_local, n_steps)
        port = hedged_terminal_returns(term, s0, h_t, h_k, h_p, h_q) @ w
        counts = jax.lax.psum(histogram(port, sketch), axis)
        p_sum = jax.lax.psum(port.sum(), axis)
        v, c = sketch_var_cvar(counts, alpha, sketch)
        return v, c, p_sum / n_paths

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),) * 9, out_specs=(P(), P(), P()),
        check_vma=False,
    ))
    dt = jnp.float32
    return fn(
        jnp.asarray(seed, jnp.int32),
        jnp.asarray(params.mean_step, dt), jnp.asarray(params.chol_step, dt),
        jnp.asarray(params.s0, dt), jnp.asarray(weights, dt), *hedge.arrays,
    )


def sharded_path_risk(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    use_pallas: bool = False,
    axis: str = "paths",
    bm: str = "poly",
) -> PathRiskReport:
    """Drawdown + terminal tail risk over a mesh (psum'd histogram sketches).

    ``bm="poly_fast"`` selects the screening-tier kernel normals on the
    Pallas path (see pallas_gbm._boxmuller_poly_fast); ignored by the lax
    tier."""
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev

    def local(seed, mean_step, chol_step, weights):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        if use_pallas:
            from mcport.ops.pallas_gbm import gbm_path_stats

            _, port, dd = gbm_path_stats(
                dev_seed, mean_step, chol_step, weights, n_local, n_steps, bm=bm
            )
        else:
            key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
            port, dd = _lax_path_stats(
                key, mean_step, chol_step, weights, n_local, n_steps, mean_step.dtype
            )
        psum = lambda x: jax.lax.psum(x, axis)
        h_port = psum(histogram(port, sketch))
        h_dd = psum(histogram(dd, dd_sketch))
        s_port = psum(port.sum())
        s_dd = psum(dd.sum())
        v, c = sketch_var_cvar(h_port, alpha, sketch)
        dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
        dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
        return v, c, s_port, s_dd, dd_p95, dd_med

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(), P(), P()),
                           out_specs=(P(), P(), P(), P(), P(), P()), check_vma=False))
    v, c, s_port, s_dd, dd_p95, dd_med = fn(
        jnp.asarray(seed, jnp.int32), jnp.asarray(mean_step),
        jnp.asarray(chol_step), jnp.asarray(weights),
    )
    return PathRiskReport(
        var=float(v), cvar=float(c),
        port_mean=float(s_port) / n_paths, dd_mean=float(s_dd) / n_paths,
        dd_p95=float(dd_p95), dd_median=float(dd_med), n_paths=n_paths,
    )



def _family_model_args(model: str, model_params) -> tuple:
    """Flatten a family's parameter object into the f32 array tuple the
    sharded locals unpack — ONE place, so adding a model field cannot drift
    between the path-risk / 1-D frontier / 2-D frontier engines."""
    if model == "garch":
        p = model_params
        return tuple(jnp.asarray(x, jnp.float32) for x in (
            p.mu, p.omega, p.alpha, p.beta, p.corr_chol, p.sigma2_0, p.eps2_0))
    if model == "dcc":
        p = model_params
        b = p.base
        s_mat = np.asarray(b.corr_chol) @ np.asarray(b.corr_chol).T
        return tuple(jnp.asarray(x, jnp.float32) for x in (
            b.mu, b.omega, b.alpha, b.beta, s_mat, p.q0, p.e0,
            b.sigma2_0, b.eps2_0, np.float32(p.a_dcc), np.float32(p.b_dcc)))
    if model == "jump":
        p = model_params
        return tuple(jnp.asarray(x, jnp.float32) for x in (
            p.diffusion.mean_step, p.diffusion.chol_step,
            np.float32(p.jump_rate), p.jump_mean, p.jump_vol))
    if model == "heston":
        p = model_params
        return tuple(jnp.asarray(x, jnp.float32) for x in (
            p.mu, p.kappa, p.theta, p.xi, p.rho, p.v0, p.corr_chol))
    return (jnp.asarray(model_params, jnp.float32),)


def _family_chunk_stats(model, model_args, h_args, key, w_blk, n_paths,
                        n_steps, p_restart):
    """(term (B, n), dd (B, n)) for one candidate block of any family — the
    shared lax dispatch of the sharded locals (w_blk is (B, A))."""
    if model == "garch":
        from mcport.models.garch_mc import _path_stats

        (mu, omega, alpha_g, beta, corr_chol, sigma2_0, eps2_0) = model_args
        return _path_stats(key, mu, omega, alpha_g, beta, corr_chol.T,
                           sigma2_0, eps2_0, w_blk.T, n_paths, n_steps,
                           jnp.float32, h_args)
    if model == "dcc":
        from mcport.models.dcc import _dcc_path_stats_impl

        (mu, omega, alpha_g, beta, s_mat, q0, e0, sigma2_0, eps2_0,
         a_dcc, b_dcc) = model_args
        return _dcc_path_stats_impl(key, mu, omega, alpha_g, beta, s_mat,
                                    q0, e0, sigma2_0, eps2_0, a_dcc, b_dcc,
                                    w_blk.T, n_paths, n_steps, jnp.float32,
                                    h_args)
    if model == "jump":
        from mcport.models.jump import merton_path_stats

        (mean_step, chol_step, rate, mu_j, sig_j) = model_args
        return merton_path_stats(key, mean_step, chol_step, rate, mu_j,
                                 sig_j, w_blk, n_paths, n_steps,
                                 hedge_args=h_args)
    if model == "heston":
        from mcport.models.heston import _path_stats

        (mu, kappa, theta, xi, rho, v0, corr_chol) = model_args
        return _path_stats(key, mu, kappa, theta, xi, rho, v0, corr_chol.T,
                           w_blk.T, n_paths, n_steps, jnp.float32, h_args)
    from mcport.models.bootstrap import bootstrap_path_stats

    (history,) = model_args
    return bootstrap_path_stats(key, history, w_blk, n_paths, n_steps,
                                p_restart=p_restart, hedge_args=h_args)


def sharded_family_path_risk(
    seed,
    model: str,
    model_params,
    weights,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    p_restart: float = 0.2,
    hedge=None,
    s0=None,
    axis: str = "paths",
) -> PathRiskReport:
    """Mesh-sharded model-family path risk: terminal VaR/CVaR + max-drawdown
    distribution under CCC-GARCH ("garch"), DCC-GARCH ("dcc"), common-jump
    Merton ("jump"), Heston stochastic-volatility ("heston"), or
    stationary-bootstrap ("bootstrap") paths — the
    family counterpart of
    :func:`sharded_path_risk`, same communication shape (each device evolves
    its own counter-seeded path slice through the lax path-stats engines and
    only the two histogram sketches + two scalars psum across devices).
    ``hedge`` (a HedgeSpec) + ``s0`` switch every device to hedged
    per-period option settlement. Returns a replicated
    :class:`mcport.engine.path_risk.PathRiskReport`."""
    from mcport.models.bootstrap import _auto_sketch_from_history

    if model not in ("garch", "dcc", "jump", "heston", "bootstrap"):
        raise ValueError(
            f"model must be 'garch', 'dcc', 'jump', 'heston' or 'bootstrap', "
            f"got {model!r}")
    if hedge is not None and s0 is None:
        raise ValueError("hedged family path risk requires s0 (asset prices)")
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    if sketch is None:
        sketch = (SketchConfig() if model != "bootstrap" or hedge is not None
                  else _auto_sketch_from_history(np.asarray(model_params),
                                                 n_steps))
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    n_hedge = 0 if hedge_args is None else len(hedge_args)

    def local(seed, weights, *rest):
        if n_hedge:
            model_args, h_args = rest[:-n_hedge], rest[-n_hedge:]
        else:
            model_args, h_args = rest, None
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        w = weights[None, :]
        term, dd = _family_chunk_stats(model, model_args, h_args, key, w,
                                        n_local, n_steps, p_restart)
        port, ddv = term[0], dd[0]
        psum = lambda x: jax.lax.psum(x, axis)
        h_port = psum(histogram(port, sketch))
        h_dd = psum(histogram(ddv, dd_sketch))
        s_port = psum(port.sum())
        s_dd = psum(ddv.sum())
        v, c = sketch_var_cvar(h_port, alpha, sketch)
        dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
        dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
        return v, c, s_port, s_dd, dd_p95, dd_med

    model_in = _family_model_args(model, model_params)
    args = (jnp.asarray(seed, jnp.int32), jnp.asarray(weights, jnp.float32),
            *model_in, *(hedge_args or ()))
    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),) * len(args),
        out_specs=(P(),) * 6, check_vma=False,
    ))
    v, c, s_port, s_dd, dd_p95, dd_med = fn(*args)
    return PathRiskReport(
        var=float(v), cvar=float(c),
        port_mean=float(s_port) / n_paths, dd_mean=float(s_dd) / n_paths,
        dd_p95=float(dd_p95), dd_median=float(dd_med), n_paths=n_paths,
    )


class _Best(NamedTuple):
    weights: Array
    metric: Array


@partial(
    jax.jit,
    static_argnames=("n_candidates", "n_paths", "n_steps", "mesh", "alpha",
                     "objective", "axis"),
)
def sharded_simulated_frontier(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    min_weights: Array,
    max_weights: Array,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    risk_free: float = 0.0,
    alpha: float = 0.95,
    objective: str = "cvar",
    axis: str = "cand",
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """Candidate-sharded simulated-frontier search → (best weights, best metric).

    Every device draws the SAME terminal path set (identical key — replication by
    construction beats broadcasting 16k x A floats between devices) and its OWN candidate
    shard; winners resolve via one tiny all_gather.

    ``hedge_args = (s0, *HedgeSpec.arrays)`` scores candidates against HEDGED
    terminal returns (mcport.options.hedged terminal settlement) — the leg
    arrays are replicated (tiny) and the transform runs inside the
    shard_map, so communication is unchanged.
    """
    n_dev = mesh.shape[axis]
    if n_candidates % n_dev:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev}")
    n_local = n_candidates // n_dev
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))

    def local(key, mean_step, chol_step, min_w, max_w):
        idx = jax.lax.axis_index(axis)
        k_path, k_w = jax.random.split(key)
        term = terminal_log_returns(k_path, mean_step, chol_step, n_paths, n_steps,
                                    dtype=mean_step.dtype)
        if hedge_args is not None:
            from mcport.options.hedged import hedged_terminal_returns

            s0, ht, hk, hp, hq = hedge_args
            gross = hedged_terminal_returns(
                jnp.asarray(term), jnp.asarray(s0, term.dtype),
                jnp.asarray(ht), jnp.asarray(hk), jnp.asarray(hp),
                jnp.asarray(hq))
        else:
            gross = jnp.exp(term) - 1.0
        w, valid = sample_constrained_weights(
            jax.random.fold_in(k_w, idx), n_local, min_w, max_w
        )
        w = w.astype(gross.dtype)
        port = gross @ w.T                               # (P, B)
        ret = port.mean(axis=0)
        std = port.std(axis=0, ddof=1)
        sharpe = jnp.where(std > 0, (ret - risk_free) / jnp.where(std > 0, std, 1.0), 0.0)
        worst, _ = jax.lax.top_k(-port.T, k_tail)
        var = -worst[:, -1]
        cvar = -worst.mean(axis=1)
        metric = {"sharpe": sharpe, "return": ret, "var": var, "cvar": cvar}[objective]
        metric = jnp.where(valid, metric, -jnp.inf)
        best = jnp.argmax(metric)
        all_m = jax.lax.all_gather(metric[best], axis)
        all_w = jax.lax.all_gather(w[best], axis)
        g = jnp.argmax(all_m)
        # no-valid guard (parity with sharded_weight_search): if every
        # candidate failed the bounds the winner is a raw invalid draw —
        # return NaN weights so callers cannot trade it silently
        w_out = jnp.where(jnp.isfinite(all_m[g]), all_w[g], jnp.nan)
        return w_out, all_m[g]

    fn = shard_map(local, mesh=mesh, in_specs=(P(), P(), P(), P(), P()),
                   out_specs=(P(), P()), check_vma=False)
    return fn(key, jnp.asarray(mean_step), jnp.asarray(chol_step),
              jnp.asarray(min_weights), jnp.asarray(max_weights))


def sharded_bootstrap_risk(
    key: Array,
    returns: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    p_restart: float = 0.2,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
):
    """Mesh-sharded stationary-bootstrap tail risk (psum'd histogram sketch).

    Same zero-input-communication pattern as the GBM engines: every device
    resamples its own path slice from ``fold_in(key, axis_index)`` and only the
    (n_bins,) counts + two scalars cross devices. Returns a
    :class:`mcport.models.bootstrap.BootstrapRisk` (replicated).
    """
    from mcport.models.bootstrap import (
        BootstrapRisk,
        _auto_sketch_from_history,
        bootstrap_terminal_returns,
    )
    from mcport.ops.quantile import histogram, sketch_var_cvar

    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    if sketch is None:
        sketch = _auto_sketch_from_history(np.asarray(returns), n_steps)

    def local(key, returns, weights):
        idx = jax.lax.axis_index(axis)
        term = bootstrap_terminal_returns(
            jax.random.fold_in(key, idx), returns, n_local, n_steps, p_restart
        )
        port = term @ weights
        psum = lambda x: jax.lax.psum(x, axis)
        counts = psum(histogram(port, sketch))
        port_sum = psum(port.sum())
        mean = psum(term.sum(axis=0)) / n_paths
        v, c = sketch_var_cvar(counts, alpha, sketch)
        return BootstrapRisk(v, c, port_sum / n_paths, mean, counts)

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=BootstrapRisk(P(), P(), P(), P(), P()), check_vma=False,
    ))
    return fn(key, jnp.asarray(returns, jnp.float32),
              jnp.asarray(weights, jnp.float32))


def sharded_simulated_frontier_2d(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    min_weights: Array,
    max_weights: Array,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    risk_free: float = 0.0,
    alpha: float = 0.95,
    objective: str = "cvar",
    sketch: SketchConfig | None = None,
    paths_axis: str = "paths",
    cand_axis: str = "cand",
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """Simulated-frontier search sharded over BOTH mesh axes (dp x tp).

    ``hedge_args = (s0, *HedgeSpec.arrays)`` scores hedged terminal returns
    (replicated leg arrays; default sketch switches to the exact-PWL-bounds
    hedged form).

    The 1-D form (:func:`sharded_simulated_frontier`) replicates the whole path
    set on every device; here paths shard too — each device simulates only its
    (paths-shard x candidate-shard) tile:

    - per-candidate MEAN/VAR reduce exactly via ``psum`` of (sum, sum-of-squares)
      over the paths axis;
    - per-candidate TAIL metrics reduce as per-candidate histogram sketches
      (B_local x n_bins counts, psum over paths) — the same
      no-gather-of-paths discipline as the risk engines, at one-bin-width
      quantile accuracy;
    - the winner resolves with one all_gather over the candidate axis.

    Path draws are counter-derived per paths-shard (``fold_in(key, p_idx)``) so
    every candidate column sees the SAME global path set regardless of the
    candidate shard it lives in — scores are comparable across the whole mesh.
    """
    from mcport.ops.quantile import auto_sketch, sketch_var_cvar

    n_dev_p = mesh.shape[paths_axis]
    n_dev_c = mesh.shape[cand_axis]
    if n_paths % n_dev_p:
        raise ValueError(f"n_paths {n_paths} not divisible by {n_dev_p}")
    if n_candidates % n_dev_c:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev_c}")
    n_local_p = n_paths // n_dev_p
    n_local_c = n_candidates // n_dev_c
    if sketch is None:
        if hedge_args is not None:
            from types import SimpleNamespace

            from mcport.options.hedged import HedgeSpec, auto_hedged_sketch

            s0, ht, hk, hp, hq = (np.asarray(x) for x in hedge_args)
            sketch = auto_hedged_sketch(
                SimpleNamespace(mean_step=np.asarray(mean_step),
                                chol_step=np.asarray(chol_step), s0=s0),
                n_steps,
                HedgeSpec(ht, hk, hp, hq, np.zeros(len(s0), bool)),
                n_bins=2048)
        else:
            sketch = auto_sketch(mean_step, chol_step, n_steps, n_bins=2048)

    def local(key, mean_step, chol_step, min_w, max_w):
        p_idx = jax.lax.axis_index(paths_axis)
        c_idx = jax.lax.axis_index(cand_axis)
        k_path, k_w = jax.random.split(key)
        term = terminal_log_returns(
            jax.random.fold_in(k_path, p_idx), mean_step, chol_step,
            n_local_p, n_steps, dtype=mean_step.dtype,
        )
        if hedge_args is not None:
            from mcport.options.hedged import hedged_terminal_returns

            h_s0, h_t, h_k, h_p, h_q = hedge_args
            gross = hedged_terminal_returns(
                term, jnp.asarray(h_s0, term.dtype), jnp.asarray(h_t),
                jnp.asarray(h_k), jnp.asarray(h_p), jnp.asarray(h_q))
        else:
            gross = jnp.exp(term) - 1.0                    # (p_local, A)
        w, valid = sample_constrained_weights(
            jax.random.fold_in(k_w, c_idx), n_local_c, min_w, max_w
        )
        w = w.astype(gross.dtype)
        port = gross @ w.T                                 # (p_local, B_local)

        psum_p = lambda x: jax.lax.psum(x, paths_axis)
        s1 = psum_p(port.sum(axis=0))                      # (B,) exact sums
        s2 = psum_p((port * port).sum(axis=0))
        ret = s1 / n_paths
        var_p = jnp.maximum((s2 - n_paths * ret * ret) / (n_paths - 1), 0.0)
        std = jnp.sqrt(var_p)
        sharpe = jnp.where(std > 0, (ret - risk_free) / jnp.where(std > 0, std, 1.0), 0.0)

        # per-candidate tail sketch: (B_local, n_bins) counts, psum over paths
        counts = jax.vmap(lambda col: histogram(col, sketch), in_axes=1)(port)
        counts = psum_p(counts)
        v, c = jax.vmap(lambda h: sketch_var_cvar(h, alpha, sketch))(counts)

        metric = {"sharpe": sharpe, "return": ret, "var": v, "cvar": c}[objective]
        metric = jnp.where(valid, metric, -jnp.inf)
        best = jnp.argmax(metric)
        all_m = jax.lax.all_gather(metric[best], cand_axis)
        all_w = jax.lax.all_gather(w[best], cand_axis)
        g = jnp.argmax(all_m)
        # no-valid guard: NaN weights when every candidate failed the bounds
        w_out = jnp.where(jnp.isfinite(all_m[g]), all_w[g], jnp.nan)
        return w_out, all_m[g]

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P()), check_vma=False,
    ))
    return fn(key, jnp.asarray(mean_step), jnp.asarray(chol_step),
              jnp.asarray(min_weights), jnp.asarray(max_weights))


def sharded_drawdown_frontier(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    min_weights: Array,
    max_weights: Array,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    dd_budget: float = 0.30,
    alpha: float = 0.95,
    axis: str = "cand",
    w_block: int = 64,
    rebalance: bool = False,
) -> tuple[Array, Array, Array, Array]:
    """Candidate-sharded drawdown-constrained frontier search.

    Mesh form of :func:`mcport.engine.drawdown_frontier.drawdown_frontier_search`
    (reference capability: max simulated return s.t. a p95-worst max-drawdown
    budget). Every device simulates the SAME full path set (identical path key —
    replication by construction, zero path communication) and scores only its
    own candidate shard through the lax value-path scorer; the single
    cross-device exchange is the tiny per-device-winner all_gather. A feasible
    count psums so callers can distinguish "infeasible everywhere" (ret
    returns -inf) from a real optimum.

    Returns ``(best_weights, best_ret, best_dd_p95, n_feasible)``.
    """
    from mcport.engine.drawdown_frontier import _lax_multi_dd

    n_dev = mesh.shape[axis]
    if n_candidates % n_dev:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev}")
    n_local = n_candidates // n_dev
    if n_local % w_block and n_local > w_block:
        raise ValueError(f"local candidates {n_local} not divisible by w_block {w_block}")
    block = min(w_block, n_local)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))
    budget = abs(dd_budget)

    def local(key, mean_step, chol_step, min_w, max_w):
        idx = jax.lax.axis_index(axis)
        k_path, k_w = jax.random.split(key)
        w, valid = sample_constrained_weights(
            jax.random.fold_in(k_w, idx), n_local, min_w, max_w
        )
        w = w.astype(mean_step.dtype)

        def chunk(w_blk):
            term, dd = _lax_multi_dd(
                k_path, mean_step, chol_step, w_blk, n_paths, n_steps,
                mean_step.dtype, rebalance,
            )
            ret = term.mean(axis=1)
            worst, _ = jax.lax.top_k(-dd, k_tail)
            return ret, -worst[:, -1]

        ret, dd_p95 = jax.lax.map(chunk, w.reshape(-1, block, w.shape[-1]))
        ret, dd_p95 = ret.reshape(-1), dd_p95.reshape(-1)
        feasible = valid & (dd_p95 >= -budget)
        score = jnp.where(feasible, ret, -jnp.inf)
        best = jnp.argmax(score)
        n_feas = jax.lax.psum(feasible.sum(), axis)
        all_s = jax.lax.all_gather(score[best], axis)
        all_w = jax.lax.all_gather(w[best], axis)
        all_d = jax.lax.all_gather(dd_p95[best], axis)
        g = jnp.argmax(all_s)
        # no-feasible guard (parity with the simulated-frontier forms): when
        # every candidate busts the budget or bounds, score is -inf and the
        # winner is an arbitrary invalid draw — NaN the weights so callers
        # checking only weights cannot trade it
        w_out = jnp.where(jnp.isfinite(all_s[g]), all_w[g], jnp.nan)
        return w_out, all_s[g], all_d[g], n_feas

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()), check_vma=False,
    ))
    return fn(key, jnp.asarray(mean_step), jnp.asarray(chol_step),
              jnp.asarray(min_weights), jnp.asarray(max_weights))


def sharded_family_drawdown_frontier(
    key: Array,
    model: str,
    model_params,
    min_weights: Array,
    max_weights: Array,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    dd_budget: float = 0.30,
    alpha: float = 0.95,
    axis: str = "cand",
    w_block: int = 64,
    p_restart: float = 0.2,
    hedge=None,
    s0=None,
) -> tuple[Array, Array, Array, Array]:
    """Candidate-sharded FAMILY drawdown frontier: the mesh form of
    :func:`mcport.engine.drawdown_frontier.family_drawdown_frontier_search`
    (max expected simulated return s.t. the p95-worst max drawdown budget,
    under "garch" / "dcc" / "jump" / "heston" / "bootstrap" paths).

    Same communication shape as :func:`sharded_drawdown_frontier`: every
    device scores its own candidate shard against an IDENTICAL path set
    (same path key on all devices — replication by construction), and the
    only exchange is the per-device-winner all_gather plus a psum'd feasible
    count. ``hedge`` + ``s0`` switch every candidate to hedged per-period
    option settlement. Returns
    ``(best_weights, best_ret, best_dd_p95, n_feasible)`` (weights NaN when
    nothing is feasible)."""
    if model not in ("garch", "dcc", "jump", "heston", "bootstrap"):
        raise ValueError(
            f"model must be 'garch', 'dcc', 'jump', 'heston' or 'bootstrap', "
            f"got {model!r}")
    if hedge is not None and s0 is None:
        raise ValueError("hedged family frontier requires s0 (asset prices)")
    n_dev = mesh.shape[axis]
    if n_candidates % n_dev:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev}")
    n_local = n_candidates // n_dev
    if n_local % w_block and n_local > w_block:
        raise ValueError(f"local candidates {n_local} not divisible by w_block {w_block}")
    block = min(w_block, n_local)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))
    budget = abs(dd_budget)
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    n_hedge = 0 if hedge_args is None else len(hedge_args)

    def local(key, min_w, max_w, *rest):
        if n_hedge:
            model_args, h_args = rest[:-n_hedge], rest[-n_hedge:]
        else:
            model_args, h_args = rest, None
        idx = jax.lax.axis_index(axis)
        k_path, k_w = jax.random.split(key)
        w, valid = sample_constrained_weights(
            jax.random.fold_in(k_w, idx), n_local, min_w, max_w
        )
        w = w.astype(jnp.float32)

        def chunk(w_blk):
            term, dd = _family_chunk_stats(model, model_args, h_args,
                                            k_path, w_blk, n_paths, n_steps,
                                            p_restart)
            ret = term.mean(axis=1)
            worst, _ = jax.lax.top_k(-dd, k_tail)
            return ret, -worst[:, -1]

        ret, dd_p95 = jax.lax.map(chunk, w.reshape(-1, block, w.shape[-1]))
        ret, dd_p95 = ret.reshape(-1), dd_p95.reshape(-1)
        feasible = valid & (dd_p95 >= -budget)
        score = jnp.where(feasible, ret, -jnp.inf)
        best = jnp.argmax(score)
        n_feas = jax.lax.psum(feasible.sum(), axis)
        all_s = jax.lax.all_gather(score[best], axis)
        all_w = jax.lax.all_gather(w[best], axis)
        all_d = jax.lax.all_gather(dd_p95[best], axis)
        g = jnp.argmax(all_s)
        w_out = jnp.where(jnp.isfinite(all_s[g]), all_w[g], jnp.nan)
        return w_out, all_s[g], all_d[g], n_feas

    model_in = _family_model_args(model, model_params)
    args = (key, jnp.asarray(min_weights, jnp.float32),
            jnp.asarray(max_weights, jnp.float32),
            *model_in, *(hedge_args or ()))
    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),) * len(args),
        out_specs=(P(), P(), P(), P()), check_vma=False,
    ))
    return fn(*args)


def sharded_family_drawdown_frontier_2d(
    key: Array,
    model: str,
    model_params,
    min_weights: Array,
    max_weights: Array,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    dd_budget: float = 0.30,
    alpha: float = 0.95,
    paths_axis: str = "paths",
    cand_axis: str = "cand",
    w_block: int = 64,
    p_restart: float = 0.2,
    dd_sketch: SketchConfig | None = None,
    hedge=None,
    s0=None,
) -> tuple[Array, Array, Array, Array]:
    """Family drawdown frontier sharded over BOTH mesh axes (dp x tp).

    The 1-D form (:func:`sharded_family_drawdown_frontier`) replicates the
    whole path set on every device; here paths shard too — each device
    evolves only its (paths-shard x candidate-shard) tile of family paths
    ("garch"/"dcc"/"jump"/"heston"/"bootstrap"). Per-candidate expected returns
    reduce exactly (psum of sums over the paths axis); per-candidate
    drawdown p95 reduces as per-candidate DD histogram sketches
    (B_local x n_bins, psum over paths — one-bin-width quantile accuracy,
    the 2-D GBM frontier's discipline); the winner resolves with one
    all_gather over the candidate axis. Paths are keyed by the paths-shard
    index only, so every candidate column sees the SAME global path set
    regardless of which candidate shard it lives in.

    Returns ``(best_weights, best_ret, best_dd_p95, n_feasible)`` — weights
    NaN when nothing is feasible.
    """
    if model not in ("garch", "dcc", "jump", "heston", "bootstrap"):
        raise ValueError(
            f"model must be 'garch', 'dcc', 'jump', 'heston' or 'bootstrap', "
            f"got {model!r}")
    if hedge is not None and s0 is None:
        raise ValueError("hedged family frontier requires s0 (asset prices)")
    n_dev_p = mesh.shape[paths_axis]
    n_dev_c = mesh.shape[cand_axis]
    if n_paths % n_dev_p:
        raise ValueError(f"n_paths {n_paths} not divisible by {n_dev_p}")
    if n_candidates % n_dev_c:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev_c}")
    n_local_p = n_paths // n_dev_p
    n_local_c = n_candidates // n_dev_c
    if n_local_c % w_block and n_local_c > w_block:
        raise ValueError(
            f"local candidates {n_local_c} not divisible by w_block {w_block}")
    block = min(w_block, n_local_c)
    budget = abs(dd_budget)
    if dd_sketch is None:
        dd_sketch = SketchConfig(n_bins=1024, lo=-1.0, hi=0.0)
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    n_hedge = 0 if hedge_args is None else len(hedge_args)

    def local(key, min_w, max_w, *rest):
        if n_hedge:
            model_args, h_args = rest[:-n_hedge], rest[-n_hedge:]
        else:
            model_args, h_args = rest, None
        p_idx = jax.lax.axis_index(paths_axis)
        c_idx = jax.lax.axis_index(cand_axis)
        k_path, k_w = jax.random.split(key)
        k_path = jax.random.fold_in(k_path, p_idx)
        w, valid = sample_constrained_weights(
            jax.random.fold_in(k_w, c_idx), n_local_c, min_w, max_w)
        w = w.astype(jnp.float32)
        psum_p = lambda x: jax.lax.psum(x, paths_axis)

        def chunk(w_blk):
            term, dd = _family_chunk_stats(model, model_args, h_args,
                                            k_path, w_blk, n_local_p,
                                            n_steps, p_restart)
            ret = psum_p(term.sum(axis=1)) / n_paths          # (B,) exact
            counts = jax.vmap(lambda row: histogram(row, dd_sketch))(dd)
            counts = psum_p(counts)                           # (B, n_bins)
            dd95 = jax.vmap(
                lambda h: sketch_quantile(h, 1.0 - alpha, dd_sketch))(counts)
            return ret, dd95

        ret, dd_p95 = jax.lax.map(chunk, w.reshape(-1, block, w.shape[-1]))
        ret, dd_p95 = ret.reshape(-1), dd_p95.reshape(-1)
        feasible = valid & (dd_p95 >= -budget)
        score = jnp.where(feasible, ret, -jnp.inf)
        best = jnp.argmax(score)
        n_feas = jax.lax.psum(feasible.sum(), cand_axis)
        all_s = jax.lax.all_gather(score[best], cand_axis)
        all_w = jax.lax.all_gather(w[best], cand_axis)
        all_d = jax.lax.all_gather(dd_p95[best], cand_axis)
        g = jnp.argmax(all_s)
        w_out = jnp.where(jnp.isfinite(all_s[g]), all_w[g], jnp.nan)
        return w_out, all_s[g], all_d[g], n_feas

    model_in = _family_model_args(model, model_params)
    args = (key, jnp.asarray(min_weights, jnp.float32),
            jnp.asarray(max_weights, jnp.float32),
            *model_in, *(hedge_args or ()))
    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),) * len(args),
        out_specs=(P(), P(), P(), P()), check_vma=False,
    ))
    return fn(*args)


def sharded_garch_risk(
    seed: Array,
    params,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
    t_df: float | None = None,
):
    """CCC-GARCH portfolio tail risk over a mesh (psum'd covering sketch).

    Mesh form of the single-chip GARCH engine (api.compare_tail_risk /
    CLI garch-risk): each device simulates its own counter-seeded slice of
    terminal compounded returns under the stochastic-vol recursion (lax scan)
    and the only cross-device traffic is the histogram/sum psum. Returns
    ``(var, cvar, port_mean)`` floats.
    """
    from mcport.config import COVERING_LOG1P_SKETCH
    from mcport.models.garch_mc import garch_terminal_returns

    if sketch is None:
        sketch = COVERING_LOG1P_SKETCH
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    w = jnp.asarray(weights, jnp.float32)

    def local(seed, w):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        term = garch_terminal_returns(key, params, n_local, n_steps, t_df=t_df)
        port = term @ w
        psum = lambda x: jax.lax.psum(x, axis)
        hist = psum(histogram(port, sketch))
        s = psum(port.sum())
        v, c = sketch_var_cvar(hist, alpha, sketch)
        return v, c, s

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    v, c, s = fn(jnp.asarray(seed, jnp.int32), w)
    return float(v), float(c), float(s) / n_paths


def sharded_merton_risk(
    seed: Array,
    params,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
):
    """Common-jump (Merton) portfolio tail risk over a mesh.

    Mesh form of :func:`mcport.models.jump.merton_risk` — the exact terminal
    sampler is a per-device (n_local, A) draw with counter-derived keys; the
    covering sketch (GBM range widened by the worst plausible compound-Poisson
    contribution) psums, as does the jumped-path count. Returns
    ``(var, cvar, port_mean, jump_frac)`` floats.
    """
    from mcport.models.jump import default_merton_sketch, merton_terminal_returns

    if sketch is None:
        sketch = default_merton_sketch(params, n_steps)
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    w = jnp.asarray(weights, jnp.float32)
    mean_step = jnp.asarray(params.diffusion.mean_step, jnp.float32)
    chol_step = jnp.asarray(params.diffusion.chol_step, jnp.float32)

    def local(seed, w, mean_step, chol_step):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        term, n_jumps = merton_terminal_returns(
            key, mean_step, chol_step, params.jump_rate,
            params.jump_mean, params.jump_vol, n_local, n_steps,
            return_jumps=True,
        )
        port = (jnp.exp(term) - 1.0) @ w
        psum = lambda x: jax.lax.psum(x, axis)
        hist = psum(histogram(port, sketch))
        s = psum(port.sum())
        jumped = psum((n_jumps > 0).sum())
        v, c = sketch_var_cvar(hist, alpha, sketch)
        return v, c, s, jumped

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(), P(), P()),
                           out_specs=(P(), P(), P(), P()), check_vma=False))
    v, c, s, jumped = fn(jnp.asarray(seed, jnp.int32), w, mean_step, chol_step)
    return float(v), float(c), float(s) / n_paths, float(jumped) / n_paths


def sharded_importance_tail(
    seed: Array,
    params,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.9999,
    sketch: SketchConfig | None = None,
    tilt: float | None = None,
    axis: str = "paths",
):
    """Importance-sampled deep-tail VaR/CVaR over a mesh.

    Mesh form of :func:`mcport.models.importance.importance_tail_risk`: every
    device draws its own tilted slice with counter-derived keys and builds the
    likelihood-ratio-weighted sketch; masses psum exactly (weighted counts are
    still mergeable), and the exact normalizer stays the GLOBAL path count
    (E[LR] = 1 by construction). Returns ``(var, cvar, n_tail_samples)``.
    """
    from mcport.models.importance import (
        default_importance_sketch,
        default_tilt,
        tilted_terminal_returns,
        weighted_histogram,
    )

    if tilt is None:
        tilt = default_tilt(alpha)
    if sketch is None:
        sketch = default_importance_sketch(params, n_steps, tilt)
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    w = jnp.asarray(weights, jnp.float32)
    mean_step = jnp.asarray(params.mean_step, jnp.float32)
    chol_step = jnp.asarray(params.chol_step, jnp.float32)

    def local(seed, w, mean_step, chol_step):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        term, log_lr = tilted_terminal_returns(
            key, mean_step, chol_step, w, tilt, n_local, n_steps,
        )
        lr = jnp.exp(log_lr)
        port = (jnp.exp(term) - 1.0) @ w
        psum = lambda x: jax.lax.psum(x, axis)
        hist = psum(weighted_histogram(port, lr, sketch))
        v = sketch_quantile(hist, 1.0 - alpha, sketch,
                            total=jnp.asarray(n_paths, hist.dtype))
        from mcport.ops.quantile import sketch_tail_mean

        c = sketch_tail_mean(hist, v, sketch)
        n_tail = psum(jnp.sum(port <= v))
        return v, c, n_tail

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(), P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    v, c, n_tail = fn(jnp.asarray(seed, jnp.int32), w, mean_step, chol_step)
    return float(v), float(c), int(n_tail)


def sharded_dcc_risk(
    seed: Array,
    params,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
):
    """DCC-GARCH portfolio tail risk over a mesh (psum'd covering sketch).

    Mesh form of :func:`mcport.models.dcc.dcc_risk`: each device simulates
    its own counter-seeded slice of dynamic-correlation paths (per-path
    (A, A) Q state stays device-local — it is per-path state, so sharding
    paths shards it for free) and the only cross-device traffic is the
    histogram/sum psum. Returns ``(var, cvar, port_mean)`` floats.
    """
    from mcport.config import COVERING_LOG1P_SKETCH
    from mcport.models.dcc import dcc_terminal_returns

    if sketch is None:
        sketch = COVERING_LOG1P_SKETCH
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    w = jnp.asarray(weights, jnp.float32)

    def local(seed, w):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        term = dcc_terminal_returns(key, params, n_local, n_steps)
        port = term @ w
        psum = lambda x: jax.lax.psum(x, axis)
        hist = psum(histogram(port, sketch))
        s = psum(port.sum())
        v, c = sketch_var_cvar(hist, alpha, sketch)
        return v, c, s

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    v, c, s = fn(jnp.asarray(seed, jnp.int32), w)
    return float(v), float(c), float(s) / n_paths


def sharded_cvar_attribution(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    mesh: Mesh,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    axis: str = "paths",
):
    """Euler CVaR attribution over a mesh — per-asset tail contributions at
    16M+ path scale without materializing the path cloud anywhere.

    Two phases over the SAME counter-seeded terminal draws (regenerating the
    deterministic streams is the repo's standard alternative to storing
    paths): (1) psum'd histogram sketch -> the VaR threshold (one-bin-width
    accuracy, like every sharded tail metric here); (2) masked per-asset
    sums against that threshold, psum'd. Components sum EXACTLY to the
    masked tail mean at the sketch threshold (the Euler identity is
    pointwise; only the threshold carries sketch error).

    Returns ``(var, cvar, contributions (A,), n_tail)``.
    """
    from mcport.ops.quantile import auto_sketch

    if sketch is None:
        sketch = auto_sketch(np.asarray(mean_step), np.asarray(chol_step),
                             n_steps)
    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    w = jnp.asarray(weights, jnp.float32)
    mean_j = jnp.asarray(mean_step, jnp.float32)
    chol_j = jnp.asarray(chol_step, jnp.float32)

    def draw(seed):
        idx = jax.lax.axis_index(axis)
        dev_seed = (seed + idx * SEED_STRIDE).astype(jnp.int32)
        key = jax.random.fold_in(jax.random.PRNGKey(0), dev_seed)
        term = terminal_log_returns(key, mean_j, chol_j, n_local, n_steps,
                                    dtype=jnp.float32)
        return jnp.exp(term) - 1.0

    def local(seed, w):
        gross = draw(seed)
        port = gross @ w
        psum = lambda x: jax.lax.psum(x, axis)
        hist = psum(histogram(port, sketch))
        v, _ = sketch_var_cvar(hist, alpha, sketch)
        mask = (port <= v).astype(jnp.float32)
        n_tail = psum(mask.sum())
        comp = psum((gross * mask[:, None]).sum(axis=0))
        comp = w * comp / jnp.maximum(n_tail, 1.0)
        return v, comp, n_tail

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P(), P()), check_vma=False))
    v, comp, n_tail = fn(jnp.asarray(seed, jnp.int32), w)
    comp = np.asarray(comp, np.float64)
    return float(v), float(comp.sum()), comp, int(n_tail)


def sharded_american_value(
    seed,
    s0,
    sigma_step,
    strike,
    mesh: Mesh,
    is_put=True,
    rate_step: float = 0.0,
    div_step: float = 0.0,
    n_paths: int = 131_072,
    n_steps: int = 252,
    antithetic: bool = True,
    axis: str = "paths",
):
    """Distributed Longstaff-Schwartz over a paths mesh.

    The LSMC backward pass is a regression per exercise date; distributing it
    is a textbook distributed-least-squares: every device evolves its own
    counter-seeded slice of the risk-neutral paths, and per backward step the
    (K, K) Gram matrix and (K,) moment vector of the normal equations psum
    across the mesh — K = 4 (cubic moneyness basis), so the per-step interconnect
    traffic is 20 floats, never a gather of paths. Every device then solves
    the identical K×K system and applies the GLOBAL regression to its local
    paths; the fitted policy (betas/boundaries) is replicated by
    construction. The ITM support bounds ride pmin/pmax, the value mean and
    its antithetic-pair standard error ride two more psums.

    The fit uses all ``n_paths`` paths jointly — the result is a single
    global LSMC estimate (statistically identical to the single-chip
    :func:`mcport.options.american.american_value`, not an average of
    per-device fits; streams differ, so values agree within MC error, pinned
    in tests/test_sharded_engines.py). Returns the same
    :class:`~mcport.options.american.AmericanPolicy`.
    """
    from mcport.options.american import (_RIDGE, AmericanPolicy, _basis,
                                         _boundaries, _intrinsic,
                                         bs_european_value)

    n_dev = mesh.shape[axis]
    if n_paths % n_dev:
        raise ValueError(f"n_paths {n_paths} not divisible by mesh axis size {n_dev}")
    n_local = n_paths // n_dev
    if antithetic and n_local % 2:
        raise ValueError("antithetic pairing needs an even per-device path count")
    s0 = np.atleast_1d(np.asarray(s0, np.float32))
    sig = np.broadcast_to(np.asarray(sigma_step, np.float32), s0.shape)
    k_arr = np.broadcast_to(np.asarray(strike, np.float32), s0.shape)
    puts = np.broadcast_to(np.asarray(is_put, bool), s0.shape)
    if np.any(sig <= 0.0) or np.any(k_arr <= 0.0) or np.any(s0 <= 0.0):
        raise ValueError("need s0 > 0, strike > 0, sigma > 0")

    half = n_local // 2 if antithetic else n_local
    disc = float(np.exp(-rate_step))
    n_pairs = n_paths // 2 if antithetic else n_paths

    def local(seed_j, s0j, sigj, kj, putj):
        idx = jax.lax.axis_index(axis)
        dev_key = jax.random.fold_in(jax.random.PRNGKey(0),
                                     seed_j + idx * SEED_STRIDE)

        def one(args):
            i, s0_i, sig_i, k_i, put_i = args
            key = jax.random.fold_in(dev_key, i)
            drift = rate_step - div_step - 0.5 * sig_i * sig_i

            def sim_step(logs, t):
                z = jax.random.normal(jax.random.fold_in(key, t), (half,),
                                      jnp.float32)
                if antithetic:
                    z = jnp.concatenate([z, -z])
                logs = logs + drift + sig_i * z
                return logs, logs

            _, log_paths = jax.lax.scan(sim_step,
                                        jnp.zeros(n_local, jnp.float32),
                                        jnp.arange(n_steps))
            s_paths = s0_i * jnp.exp(log_paths)          # (T, n_local)
            cash = _intrinsic(s_paths[-1], k_i, put_i)

            def back_step(cash, s_t):
                pay = _intrinsic(s_t, k_i, put_i)
                x = s_t / k_i
                itm = (pay > 0.0).astype(jnp.float32)
                b = _basis(x)
                bw = b * itm[:, None]
                y = cash * disc
                # the one load-bearing collective: global normal equations
                gram = jax.lax.psum(bw.T @ bw, axis)
                bty = jax.lax.psum(bw.T @ y, axis)
                gram = gram + (_RIDGE * n_paths) * jnp.eye(
                    b.shape[1], dtype=jnp.float32)
                beta = jnp.linalg.solve(gram, bty)
                cont = b @ beta
                ex = (itm > 0.0) & (pay >= cont)
                has = jax.lax.psum(itm.sum(), axis) > 0.0
                lo = jnp.min(jnp.where(itm > 0.0, x, jnp.inf))
                hi = jnp.max(jnp.where(itm > 0.0, x, -jnp.inf))
                lo = jnp.where(has, jax.lax.pmin(lo, axis), 1.0)
                hi = jnp.where(has, jax.lax.pmax(hi, axis), 1.0)
                return jnp.where(ex, pay, y), (beta, lo, hi)

            cash2, (betas_rev, lo_rev, hi_rev) = jax.lax.scan(
                back_step, cash, s_paths[-2::-1])
            v = cash2 * disc
            pm = 0.5 * (v[:half] + v[half:]) if antithetic else v
            s1 = jax.lax.psum(pm.sum(), axis)
            s2 = jax.lax.psum((pm * pm).sum(), axis)
            cont0 = s1 / n_pairs
            var = (s2 - s1 * s1 / n_pairs) / (n_pairs - 1)
            se = jnp.sqrt(jnp.maximum(var, 0.0) / n_pairs)
            value = jnp.maximum(cont0, _intrinsic(s0_i, k_i, put_i))
            return value, se, betas_rev[::-1], lo_rev[::-1], hi_rev[::-1]

        idx_a = jnp.arange(s0j.shape[0])
        return jax.lax.map(one, (idx_a, s0j, sigj, kj, putj))

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(),) * 5,
                           out_specs=(P(),) * 5, check_vma=False))
    value, se, betas, x_lo, x_hi = fn(
        jnp.asarray(seed, jnp.int32), jnp.asarray(s0), jnp.asarray(sig),
        jnp.asarray(k_arr), jnp.asarray(puts))
    eur = bs_european_value(s0, sig, k_arr, puts, rate_step, n_steps,
                            div_step)
    betas, x_lo, x_hi = (np.asarray(betas), np.asarray(x_lo),
                         np.asarray(x_hi))
    kk = np.asarray(k_arr, np.float64)
    pp = np.asarray(puts)
    return AmericanPolicy(
        strike=kk, is_put=pp, rate_step=float(rate_step), betas=betas,
        x_lo=x_lo, x_hi=x_hi,
        boundary=_boundaries(betas, x_lo, x_hi, kk, pp),
        value=np.asarray(value, np.float64), se=np.asarray(se, np.float64),
        european=np.asarray(eur, np.float64))
