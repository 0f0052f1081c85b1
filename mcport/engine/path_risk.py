"""Path-dependent risk: max-drawdown distribution of a GBM portfolio.

The reference computes drawdown only on *historical* returns (app.py:252-256);
simulated forward-looking drawdown requires evolving full paths — that is what
the fused ``gbm_path_stats`` kernel produces (per-path terminal return,
portfolio terminal, running max drawdown, all held in registers). This module chunks
it like the terminal engine and reduces two histogram sketches on device:
terminal portfolio return (VaR/CVaR) and max drawdown (drawdown quantiles).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mcport.config import GBMConfig, SketchConfig
from mcport.models.gbm import GBMParams, simulate_log_paths
from mcport.ops.dispatch import use_kernels
from mcport.ops.quantile import histogram, sketch_quantile, sketch_var_cvar
from mcport.seeding import SEED_STRIDE

__all__ = ["PathRiskReport", "run_path_risk", "run_garch_path_risk",
           "run_bootstrap_path_risk", "run_merton_path_risk",
           "run_dcc_path_risk", "run_heston_path_risk",
           "run_resumable_path_risk",
           "run_resumable_path_risk_with_recovery",
           "PathRiskCheckpoint", "load_path_risk_checkpoint", "DD_SKETCH"]

# drawdowns live in [-1, 0]; a dedicated tight sketch keeps quantile error tiny
DD_SKETCH = SketchConfig(n_bins=4096, lo=-1.0, hi=0.0)


@dataclass(frozen=True)
class PathRiskReport:
    var: float            # terminal portfolio VaR at alpha
    cvar: float
    port_mean: float
    dd_mean: float        # mean max drawdown (negative)
    dd_p95: float         # 95th-percentile worst drawdown (5% of paths are worse)
    dd_median: float
    n_paths: int
    tail_ci: dict | None = None   # config.ci_boot > 0: bootstrap error bars
                                  # {var_lo/hi/se, cvar_lo/hi/se,
                                  #  dd_p95_lo/hi/se} (floats)


def _path_tail_ci(h_port, h_dd, alpha, sketch, dd_sketch, config) -> dict | None:
    """Bootstrap error bars for the sketched terminal VaR/CVaR and dd p95
    (config.ci_boot replicates; None when 0 — pure post-processing)."""
    n_boot = int(getattr(config, "ci_boot", 0))
    if n_boot <= 0:
        return None
    from mcport.ops.quantile import (
        sketch_quantile_ci, sketch_var_cvar_ci, tail_ci_fields,
    )

    out = tail_ci_fields(sketch_var_cvar_ci(h_port, alpha, sketch,
                                            n_boot=n_boot, seed=config.seed))
    dd = sketch_quantile_ci(h_dd, 1.0 - alpha, dd_sketch, n_boot=n_boot,
                            seed=config.seed + 1)
    out.update(dd_p95_lo=float(dd["lo"]), dd_p95_hi=float(dd["hi"]),
               dd_p95_se=float(dd["se"]))
    return out


def _stats_from_log_paths(paths, weights, rebalance: bool):
    """(port terminal, max dd) of one portfolio from (n, T, A) log paths."""
    n_paths = paths.shape[0]
    dtype = paths.dtype
    w = jnp.asarray(weights, dtype)
    if rebalance:
        increments = jnp.diff(paths, axis=1, prepend=jnp.zeros(
            (n_paths, 1, paths.shape[-1]), dtype))
        growth = jnp.exp(increments) @ w                    # (n, T) w'exp(x_t)
        v = jnp.cumprod(growth, axis=1)
    else:
        v = jnp.exp(paths) @ w                              # (n, T)
    v = jnp.concatenate([jnp.ones((n_paths, 1), dtype), v], axis=1)
    peak = jax.lax.cummax(v, axis=1)
    dd = jnp.min(v / peak - 1.0, axis=1)
    port = v[:, -1] - 1.0
    return port, dd


def _hedged_stats_from_log_paths(paths, s0, h_t, h_k, h_p, h_q, weights):
    """Hedged per-period settlement over (n, T, A) log paths (W=1)."""
    from mcport.options.hedged import hedged_step_returns

    n_paths = paths.shape[0]
    dtype = paths.dtype
    s0 = jnp.asarray(s0, dtype)
    prices = s0 * jnp.exp(paths)
    p0 = jnp.broadcast_to(s0, (n_paths, 1, s0.shape[-1]))
    full = jnp.concatenate([p0, prices], axis=1)
    r_h = hedged_step_returns(full[:, :-1], full[:, 1:], h_t, h_k, h_p, h_q)
    f = 1.0 + r_h @ jnp.asarray(weights, dtype)            # (n, T)
    v = jnp.cumprod(f, axis=1)
    v = jnp.concatenate([jnp.ones((n_paths, 1), dtype), v], axis=1)
    peak = jax.lax.cummax(v, axis=1)
    dd = jnp.min(v / peak - 1.0, axis=1)
    return v[:, -1] - 1.0, dd


def _lax_path_stats(key, mean_step, chol_step, weights, n_paths, n_steps, dtype,
                    rebalance: bool = False, t_df: float | None = None):
    """Reference path-stats: full log paths → portfolio value → running peak/dd.

    ``rebalance=False`` is buy-and-hold from normalized start (V_t = w'exp(acc));
    ``rebalance=True`` resets to the target weights every period
    (V_{t+1} = V_t * w'exp(x_t) — the reference's historical R·w semantics,
    app.py:710). ``t_df`` draws unit-variance Student-t shocks."""
    paths = simulate_log_paths(key, mean_step, chol_step, n_paths, n_steps, dtype=dtype,
                               t_df=t_df)
    return _stats_from_log_paths(paths, weights, rebalance)


@partial(
    jax.jit,
    static_argnames=(
        "n_blocks", "block_paths", "n_steps", "use_pallas", "sketch", "dd_sketch",
        "rebalance", "hedged", "t_df", "bm",
    ),
)
def _accumulate(
    seed, mean_step, chol_step, weights,
    n_blocks: int, block_paths: int, n_steps: int, use_pallas: bool,
    sketch: SketchConfig, dd_sketch: SketchConfig, rebalance: bool = False,
    hedged: bool = False, hedge_args: tuple = (), t_df: float | None = None,
    bm: str = "poly",
):
    a = mean_step.shape[-1]
    dtype = mean_step.dtype

    def one_block(b, carry):
        h_port, h_dd, s_port, s_dd = carry
        block_seed = (seed + (b + 1) * SEED_STRIDE).astype(jnp.int32)
        if hedged:
            # per-period option settlement (mcport.options.hedged): score the
            # single portfolio through the hedged candidate machinery (W=1)
            if use_pallas:
                from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

                term, dd2 = gbm_multi_portfolio_dd(
                    block_seed, mean_step, chol_step, weights[None, :],
                    block_paths, n_steps, hedge_args=hedge_args, t_df=t_df,
                    bm=bm,
                )
            else:
                from mcport.engine.drawdown_frontier import _lax_multi_dd_hedged

                key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
                term, dd2 = _lax_multi_dd_hedged(
                    key, mean_step, chol_step, weights[None, :], block_paths,
                    n_steps, mean_step.dtype, *hedge_args, t_df=t_df,
                )
            port, dd = term[0], dd2[0]
        elif use_pallas:
            from mcport.ops.pallas_gbm import gbm_path_stats

            _, port, dd = gbm_path_stats(
                block_seed, mean_step, chol_step, weights, block_paths, n_steps,
                rebalance=rebalance, t_df=t_df, bm=bm,
            )
        else:
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            port, dd = _lax_path_stats(
                key, mean_step, chol_step, weights, block_paths, n_steps, dtype,
                rebalance, t_df,
            )
        return (
            h_port + histogram(port, sketch),
            h_dd + histogram(dd, dd_sketch),
            s_port + port.sum(),
            s_dd + dd.sum(),
        )

    init = (
        jnp.zeros((sketch.n_bins,), dtype),
        jnp.zeros((dd_sketch.n_bins,), dtype),
        jnp.zeros((), dtype),
        jnp.zeros((), dtype),
    )
    return jax.lax.fori_loop(0, n_blocks, one_block, init)


def run_path_risk(
    params: GBMParams,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    rebalance: bool = False,
    hedge=None,
) -> PathRiskReport:
    """Simulated path risk for one portfolio: terminal VaR/CVaR + drawdown stats.

    ``rebalance=True`` resets to the target weights every period (the
    reference's historical-series semantics); False is buy-and-hold.

    ``hedge`` (a HedgeSpec) switches to HEDGED per-period settlement
    (options settle at intrinsic value each simulated step; implies the
    rebalanced wealth recursion). Short legs can in principle drive wealth
    negative, in which case drawdowns below -1 clamp into the dd sketch's
    lowest bin.

    ``config.innovations="student_t"`` draws unit-variance Student-t shocks
    at ``config.t_dof`` in every mode (kernel and lax, hedged included) —
    fat-tail drawdown distributions with the same per-step covariance.

    ``config.qmc="sobol"|"halton"`` switches to Brownian-bridge
    low-discrepancy PATHS (:func:`mcport.models.bridge.qmc_gbm_log_paths` —
    variance concentrated in the leading dimensions, so drawdown quantiles
    converge faster than pseudo-random at the same path count); each block
    uses its own scrambling seed (randomized-QMC replicates). Incompatible
    with student_t (the bridge transform is Gaussian).

    ``config.bm="poly_fast"`` (kernel path only; lax and QMC ignore it)
    selects the screening-tier normal draws — a different stream with
    |Δz| <= ~1.5e-4 draw error; see pallas_gbm._boxmuller_poly_fast."""
    block_paths = config.path_block
    if config.n_paths % block_paths:
        raise ValueError(
            f"n_paths {config.n_paths} not divisible by path_block {block_paths}"
        )
    n_blocks = config.n_paths // block_paths
    dtype = jnp.dtype(config.dtype)
    use_pallas = use_kernels(config.use_pallas)
    t_df = float(config.t_dof) if config.innovations == "student_t" else None

    if config.qmc != "none":
        if t_df is not None:
            raise ValueError(
                "QMC path risk draws Gaussian bridge innovations; "
                "student_t is not supported with qmc != 'none'")
        from mcport.models.bridge import qmc_gbm_log_paths

        m = jnp.asarray(params.mean_step, dtype)
        chol = jnp.asarray(params.chol_step, dtype)
        w = jnp.asarray(weights, dtype)
        h_port = jnp.zeros((sketch.n_bins,), dtype)
        h_dd = jnp.zeros((dd_sketch.n_bins,), dtype)
        s_port = jnp.zeros((), dtype)
        s_dd = jnp.zeros((), dtype)
        for b in range(n_blocks):
            paths = qmc_gbm_log_paths(
                m, chol, block_paths, config.n_steps, method=config.qmc,
                seed=config.seed + (b + 1) * SEED_STRIDE, dtype=dtype)
            if hedge is not None:
                port, dd = _hedged_stats_from_log_paths(
                    paths, jnp.asarray(params.s0, dtype), *hedge.arrays, w)
            else:
                port, dd = _stats_from_log_paths(paths, w, rebalance)
            h_port = h_port + histogram(port, sketch)
            h_dd = h_dd + histogram(dd, dd_sketch)
            s_port = s_port + port.sum()
            s_dd = s_dd + dd.sum()
        v, c = sketch_var_cvar(h_port, alpha, sketch)
        dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
        dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
        n = config.n_paths
        return PathRiskReport(
            var=float(v), cvar=float(c),
            port_mean=float(s_port) / n, dd_mean=float(s_dd) / n,
            dd_p95=float(dd_p95), dd_median=float(dd_med), n_paths=n,
            tail_ci=_path_tail_ci(h_port, h_dd, alpha, sketch, dd_sketch,
                                  config),
        )

    h_port, h_dd, s_port, s_dd = _accumulate(
        jnp.asarray(config.seed, jnp.int32),
        jnp.asarray(params.mean_step, dtype),
        jnp.asarray(params.chol_step, dtype),
        jnp.asarray(weights, dtype),
        n_blocks, block_paths, config.n_steps, use_pallas, sketch, dd_sketch,
        rebalance, hedge is not None,
        () if hedge is None else (jnp.asarray(params.s0, dtype),
                                  *hedge.arrays),
        t_df, getattr(config, "bm", "poly"),
    )
    v, c = sketch_var_cvar(h_port, alpha, sketch)
    # dd quantiles: p95-worst = the 5th percentile of the (negative) dd sample
    dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
    dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
    n = config.n_paths
    return PathRiskReport(
        var=float(v), cvar=float(c),
        port_mean=float(s_port) / n,
        dd_mean=float(s_dd) / n,
        dd_p95=float(dd_p95), dd_median=float(dd_med),
        n_paths=n,
        tail_ci=_path_tail_ci(h_port, h_dd, alpha, sketch, dd_sketch, config),
    )


def _reduce_family_blocks(block_fn, config: GBMConfig, sketch: SketchConfig,
                          dd_sketch: SketchConfig, alpha: float):
    """Shared block loop for the model-family path-risk engines: ``block_fn``
    maps (block_index, block_seed) -> ((1, block) terminal, (1, block) dd);
    sketches and sums accumulate on device, a Python loop drives dispatch
    (block counts are small — tens — and the per-block engines are jitted, so
    dispatch overlaps compute; the GBM engine's fused fori_loop form is not
    worth a third jit cache per model family)."""
    block_paths = config.path_block
    if config.n_paths % block_paths:
        raise ValueError(
            f"n_paths {config.n_paths} not divisible by path_block {block_paths}"
        )
    n_blocks = config.n_paths // block_paths
    h_port = jnp.zeros((sketch.n_bins,), jnp.float32)
    h_dd = jnp.zeros((dd_sketch.n_bins,), jnp.float32)
    s_port = jnp.zeros((), jnp.float32)
    s_dd = jnp.zeros((), jnp.float32)
    for b in range(n_blocks):
        block_seed = np.int32(config.seed + (b + 1) * SEED_STRIDE)
        term, dd = block_fn(b, block_seed)
        port, ddv = term[0], dd[0]
        h_port = h_port + histogram(port, sketch)
        h_dd = h_dd + histogram(ddv, dd_sketch)
        s_port = s_port + port.sum()
        s_dd = s_dd + ddv.sum()
    v, c = sketch_var_cvar(h_port, alpha, sketch)
    dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
    dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
    n = config.n_paths
    return PathRiskReport(
        var=float(v), cvar=float(c),
        port_mean=float(s_port) / n,
        dd_mean=float(s_dd) / n,
        dd_p95=float(dd_p95), dd_median=float(dd_med),
        n_paths=n,
        tail_ci=_path_tail_ci(h_port, h_dd, alpha, sketch, dd_sketch, config),
    )


def run_garch_path_risk(
    params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> PathRiskReport:
    """Simulated path risk under CCC-GARCH(1,1) paths: terminal VaR/CVaR plus
    the max-drawdown distribution of one portfolio (the volatility-clustered
    counterpart of :func:`run_path_risk`; per-period REBALANCED wealth —
    GARCH paths are simple-return recursions, so rebalanced compounding is
    the natural reference semantics, app.py:710).

    ``params`` is a :class:`mcport.models.garch_mc.CCCGarchParams`. ``hedge``
    (a HedgeSpec) switches to hedged per-period option settlement against the
    simulated price path and requires ``s0`` (current asset prices)."""
    if hedge is not None and s0 is None:
        raise ValueError("hedged GARCH path risk requires s0 (asset prices)")
    block_fn, _ = _block_fn_for("garch", params, weights, config, hedge, s0,
                                0.2, True)
    return _reduce_family_blocks(block_fn, config, sketch, dd_sketch, alpha)


def run_merton_path_risk(
    params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
) -> PathRiskReport:
    """Simulated path risk under common-jump Merton paths: terminal VaR/CVaR
    plus the max-drawdown distribution of one portfolio — the crash-risk
    counterpart of :func:`run_path_risk` (per-period rebalanced wealth;
    per-step Bernoulli systemic jump clock, see
    :func:`mcport.models.jump.merton_path_stats`).

    ``params`` is a :class:`mcport.models.jump.MertonParams`; hedged
    settlement uses its diffusion ``s0`` prices."""
    s0 = params.diffusion.s0 if hedge is not None else None
    block_fn, _ = _block_fn_for("jump", params, weights, config, hedge, s0,
                                0.2, True)
    return _reduce_family_blocks(block_fn, config, sketch, dd_sketch, alpha)


def run_dcc_path_risk(
    params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> PathRiskReport:
    """Simulated path risk under DCC-GARCH paths: terminal VaR/CVaR plus the
    max-drawdown distribution of one portfolio — dynamic correlations that
    RISE in stress, exactly where drawdowns bite. ``params`` is a
    :class:`mcport.models.dcc.DCCGarchParams`. Hedged settlement requires
    ``s0``."""
    from mcport.models.dcc import dcc_path_stats

    if hedge is not None and s0 is None:
        raise ValueError("hedged DCC path risk requires s0 (asset prices)")
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    w = jnp.asarray(weights, jnp.float32)[None, :]

    def block_fn(_b, block_seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
        return dcc_path_stats(key, params, w, config.path_block,
                              config.n_steps, hedge_args=hedge_args)

    return _reduce_family_blocks(block_fn, config, sketch, dd_sketch, alpha)


def run_heston_path_risk(
    params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> PathRiskReport:
    """Simulated path risk under Heston stochastic-volatility paths: terminal
    VaR/CVaR plus the max-drawdown distribution of one portfolio — variance
    as its OWN mean-reverting diffusion with leverage correlation (crashes
    raise vol exactly where drawdowns deepen). ``params`` is a
    :class:`mcport.models.heston.HestonParams`; hedged settlement defaults
    ``s0`` to its spot prices."""
    if hedge is not None and s0 is None:
        s0 = np.asarray(params.s0, np.float64)
    block_fn, _ = _block_fn_for("heston", params, weights, config, hedge, s0,
                                0.2, True)
    return _reduce_family_blocks(block_fn, config, sketch, dd_sketch, alpha)


def run_bootstrap_path_risk(
    returns: np.ndarray,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    p_restart: float = 0.2,
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> PathRiskReport:
    """Simulated path risk under stationary-bootstrap resampling of the
    historical returns: terminal VaR/CVaR plus the max-drawdown distribution
    (distribution-free counterpart of :func:`run_path_risk`; per-period
    rebalanced wealth). ``sketch=None`` derives a covering log1p terminal
    sketch from the history itself (the most extreme path compounds the
    best/worst convex-combination row every step — valid for any simplex
    weight vector); hedged runs fall back to the default linear sketch since
    option settlement is not bounded by historical rows. ``hedge`` + ``s0``
    switch to hedged per-period settlement."""
    from mcport.models.bootstrap import (
        _auto_sketch_from_history, bootstrap_path_stats,
    )

    if hedge is not None and s0 is None:
        raise ValueError("hedged bootstrap path risk requires s0 (asset prices)")
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    r = jnp.asarray(returns, jnp.float32)
    if sketch is None:
        sketch = (SketchConfig() if hedge is not None else
                  _auto_sketch_from_history(np.asarray(returns), config.n_steps))
    w = jnp.asarray(weights, jnp.float32)[None, :]

    def block_fn(_b, block_seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
        return bootstrap_path_stats(key, r, w, config.path_block,
                                    config.n_steps, p_restart=p_restart,
                                    hedge_args=hedge_args)

    return _reduce_family_blocks(block_fn, config, sketch, dd_sketch, alpha)


# ---------------------------------------------------------------------------
# checkpoint/resume across every family (late round 3)
# ---------------------------------------------------------------------------

def _kernel_block_default() -> int:
    """The GBM path kernels' ``block`` default — stream-affecting (the
    Threefry key strides by ``path // block``), so the digest must track it.
    Read from the signature so a future default change automatically
    invalidates checkpoints instead of silently switching streams."""
    import inspect

    from mcport.ops.pallas_gbm import gbm_path_stats

    return int(inspect.signature(gbm_path_stats).parameters["block"].default)


def _model_digest(model, model_params, weights, config: GBMConfig, hedge,
                  s0, p_restart: float, rebalance: bool) -> str:
    """Binds a path-risk checkpoint to the exact computation (the
    mc_engine._run_digest convention): model family, every parameter array,
    weights, the seed/grid, and the hedge. Resuming anything else must be
    rejected, not silently continued."""
    import hashlib

    h = hashlib.sha256()
    h.update(model.encode())

    def arrs(*xs):
        for x in xs:
            h.update(np.ascontiguousarray(np.asarray(x, np.float64)).tobytes())

    if model in ("gbm", "student_t"):
        arrs(model_params.mean_step, model_params.chol_step, model_params.s0)
    elif model == "garch":
        p = model_params
        arrs(p.mu, p.omega, p.alpha, p.beta, p.corr_chol, p.sigma2_0, p.eps2_0)
    elif model == "dcc":
        p = model_params
        b = p.base
        arrs(b.mu, b.omega, b.alpha, b.beta, b.corr_chol, b.sigma2_0,
             b.eps2_0, p.q0, p.e0, [p.a_dcc, p.b_dcc])
    elif model == "jump":
        p = model_params
        arrs(p.diffusion.mean_step, p.diffusion.chol_step, [p.jump_rate],
             p.jump_mean, p.jump_vol)
    elif model == "heston":
        p = model_params
        arrs(p.mu, p.kappa, p.theta, p.xi, p.rho, p.v0, p.corr_chol, p.s0)
    else:  # bootstrap
        arrs(model_params, [p_restart])
    arrs(weights)
    if s0 is not None:
        arrs(s0)
    # the stream SOURCE is part of the computation: the GBM kernels draw the
    # in-kernel Threefry-2x32 stream, the lax tier jax.random — resuming a
    # kernel checkpoint on a lax backend (or vice versa) is a different run
    # and must be rejected, not silently continued with switched streams
    kernel = (model in ("gbm", "student_t")
              and use_kernels(config.use_pallas))
    stream = "kernel" if kernel else "lax"
    h.update(f"{config.seed}|{config.n_steps}|{config.n_paths}|"
             f"{config.path_block}|{config.innovations}|{config.t_dof}|"
             f"{rebalance}|{stream}".encode())
    if kernel:
        h.update(f"|kblock={_kernel_block_default()}".encode())
    t_active = config.innovations == "student_t"
    if getattr(config, "bm", "poly") != "poly" and not t_active:
        # stream-affecting normal tier (kernel path); appended only when
        # non-default so existing checkpoints keep their digests — and only
        # when it actually changes the stream (the Student-t sampler has its
        # own pipeline and ignores bm, so the draw stream is bit-identical
        # with or without the flag there)
        h.update(f"|bm={config.bm}".encode())
    if hedge is not None:
        h.update(b"hedge|" + hedge.digest_bytes())
    return h.hexdigest()


@dataclass
class PathRiskCheckpoint:
    """Resumable path-risk state: two histogram sketches + two scalar sums
    and the block cursor (streams are counter-addressed, so block b always
    draws ``seed + (b+1)*SEED_STRIDE`` regardless of when it runs)."""

    seed: int
    n_steps: int
    block_paths: int
    n_blocks: int
    next_block: int
    h_port: np.ndarray
    h_dd: np.ndarray
    s_port: np.ndarray
    s_dd: np.ndarray
    sketch_lo: float
    sketch_hi: float
    sketch_space: str
    dd_lo: float
    dd_hi: float
    digest: str = ""

    def save(self, path) -> None:
        import dataclasses as _dc

        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in _dc.fields(self)})

    @property
    def done(self) -> bool:
        return self.next_block >= self.n_blocks

    @property
    def sketch(self) -> SketchConfig:
        return SketchConfig(n_bins=int(np.asarray(self.h_port).shape[-1]),
                            lo=float(self.sketch_lo),
                            hi=float(self.sketch_hi),
                            space=str(self.sketch_space))

    @property
    def dd_sketch(self) -> SketchConfig:
        return SketchConfig(n_bins=int(np.asarray(self.h_dd).shape[-1]),
                            lo=float(self.dd_lo), hi=float(self.dd_hi))


def load_path_risk_checkpoint(path) -> PathRiskCheckpoint:
    import dataclasses as _dc

    with np.load(path) as z:
        kw = {f.name: z[f.name] for f in _dc.fields(PathRiskCheckpoint)}
    for k in ("seed", "n_steps", "block_paths", "n_blocks", "next_block"):
        kw[k] = int(kw[k])
    for k in ("sketch_lo", "sketch_hi", "dd_lo", "dd_hi"):
        kw[k] = float(kw[k])
    kw["sketch_space"] = str(kw["sketch_space"])
    kw["digest"] = str(kw["digest"])
    return PathRiskCheckpoint(**kw)


def _block_fn_for(model, model_params, weights, config: GBMConfig, hedge,
                  s0, p_restart: float, rebalance: bool):
    """(block_fn, default_sketch) for any model family — shared by the
    one-shot run_*_path_risk engines and the resumable driver. ``block_fn``
    maps (block_index, block_seed) -> ((1, B) terminal, (1, B) dd)."""
    use_pallas = use_kernels(config.use_pallas)
    w1 = jnp.asarray(weights, jnp.float32)[None, :]
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)
    default_sketch = SketchConfig()
    t_df = float(config.t_dof) if config.innovations == "student_t" else None

    if model in ("gbm", "student_t"):
        m = jnp.asarray(model_params.mean_step, jnp.float32)
        chol = jnp.asarray(model_params.chol_step, jnp.float32)
        if model == "student_t" and t_df is None:
            t_df = float(config.t_dof)
        bm = getattr(config, "bm", "poly")

        def block_fn(_b, block_seed):
            if hedge is not None:
                if use_pallas:
                    from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

                    return gbm_multi_portfolio_dd(
                        block_seed, m, chol, w1, config.path_block,
                        config.n_steps, hedge_args=hedge_args, t_df=t_df,
                        bm=bm)
                from mcport.engine.drawdown_frontier import _lax_multi_dd_hedged

                key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
                return _lax_multi_dd_hedged(
                    key, m, chol, w1, config.path_block, config.n_steps,
                    jnp.float32, *hedge_args, t_df=t_df)
            if use_pallas:
                from mcport.ops.pallas_gbm import gbm_path_stats

                _, port, dd = gbm_path_stats(
                    block_seed, m, chol, w1[0], config.path_block,
                    config.n_steps, rebalance=rebalance, t_df=t_df, bm=bm)
                return port[None, :], dd[None, :]
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            port, dd = _lax_path_stats(
                key, m, chol, w1[0], config.path_block, config.n_steps,
                jnp.float32, rebalance, t_df)
            return port[None, :], dd[None, :]

    elif model == "garch":
        from mcport.models.garch_mc import garch_path_stats

        def block_fn(_b, block_seed):
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            return garch_path_stats(key, model_params, w1, config.path_block,
                                    config.n_steps, hedge_args=hedge_args)

    elif model == "dcc":
        from mcport.models.dcc import dcc_path_stats

        def block_fn(_b, block_seed):
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            return dcc_path_stats(key, model_params, w1, config.path_block,
                                  config.n_steps, hedge_args=hedge_args)

    elif model == "jump":
        from mcport.models.jump import merton_path_stats

        p = model_params
        m = jnp.asarray(p.diffusion.mean_step, jnp.float32)
        chol = jnp.asarray(p.diffusion.chol_step, jnp.float32)
        muj = jnp.asarray(p.jump_mean, jnp.float32)
        sigj = jnp.asarray(p.jump_vol, jnp.float32)

        def block_fn(_b, block_seed):
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            return merton_path_stats(
                key, m, chol, p.jump_rate, muj, sigj, w1,
                config.path_block, config.n_steps, hedge_args=hedge_args)

    elif model == "heston":
        from mcport.models.heston import heston_path_stats

        def block_fn(_b, block_seed):
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            return heston_path_stats(key, model_params, w1, config.path_block,
                                     config.n_steps, hedge_args=hedge_args)

    elif model == "bootstrap":
        from mcport.models.bootstrap import (
            _auto_sketch_from_history, bootstrap_path_stats,
        )
        r = jnp.asarray(model_params, jnp.float32)
        if hedge is None:
            default_sketch = _auto_sketch_from_history(
                np.asarray(model_params), config.n_steps)

        def block_fn(_b, block_seed):
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            return bootstrap_path_stats(
                key, r, w1, config.path_block, config.n_steps,
                p_restart=p_restart, hedge_args=hedge_args)

    else:
        raise ValueError(
            f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', "
            f"'heston' or 'bootstrap', got {model!r}")

    return block_fn, default_sketch


def run_resumable_path_risk(
    model: str,
    model_params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    p_restart: float = 0.2,
    rebalance: bool = True,
    checkpoint: PathRiskCheckpoint | None = None,
    checkpoint_path=None,
    max_blocks: int | None = None,
) -> tuple[PathRiskReport, PathRiskCheckpoint]:
    """Checkpointable path risk under ANY model family — the preemptible
    form of the run_*_path_risk engines (block-cursor resume; streams are
    counter-addressed so a resumed run is BIT-IDENTICAL to an unsplit one).

    ``model`` is gbm / student_t / garch / dcc / jump / heston / bootstrap
    with the same ``model_params`` conventions as the one-shot engines
    (GBMParams / CCCGarchParams / DCCGarchParams / MertonParams /
    HestonParams / (T, A) history).
    Returns ``(report, checkpoint)``; the report reflects accumulation so
    far (partial when ``max_blocks`` cut the run short — check
    ``checkpoint.done``). ``checkpoint_path`` persists the state after every
    block; the digest binds the checkpoint to the exact computation and a
    mismatched resume raises."""
    if model not in ("gbm", "student_t", "garch", "dcc", "jump", "heston",
                     "bootstrap"):
        raise ValueError(
            f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', "
            f"'heston' or 'bootstrap', got {model!r}")
    if config.qmc != "none":
        raise ValueError(
            "the resumable path-risk driver draws counter-addressed "
            "pseudo-random block streams; qmc is one-shot only "
            "(run_path_risk)")
    if hedge is not None and s0 is None:
        if model in ("gbm", "student_t", "heston"):
            s0 = np.asarray(model_params.s0, np.float64)
        elif model == "jump":
            s0 = np.asarray(model_params.diffusion.s0, np.float64)
        else:
            raise ValueError(
                f"hedged {model} path risk requires s0 (asset prices)")
    block_paths = config.path_block
    if config.n_paths % block_paths:
        raise ValueError(
            f"n_paths {config.n_paths} not divisible by path_block {block_paths}")
    n_blocks = config.n_paths // block_paths
    digest = _model_digest(model, model_params, weights, config, hedge, s0,
                           p_restart, rebalance)

    block_fn, default_sketch = _block_fn_for(
        model, model_params, weights, config, hedge, s0, p_restart, rebalance)
    if checkpoint is not None:
        if checkpoint.digest and checkpoint.digest != digest:
            raise ValueError(
                "checkpoint digest mismatch: this checkpoint was written by a "
                "different computation (params/weights/config/hedge changed)")
        sketch = checkpoint.sketch
        dd_sketch = checkpoint.dd_sketch
        h_port = jnp.asarray(checkpoint.h_port, jnp.float32)
        h_dd = jnp.asarray(checkpoint.h_dd, jnp.float32)
        s_port = jnp.asarray(checkpoint.s_port, jnp.float32)
        s_dd = jnp.asarray(checkpoint.s_dd, jnp.float32)
        start = checkpoint.next_block
    else:
        if sketch is None:
            sketch = default_sketch
        h_port = jnp.zeros((sketch.n_bins,), jnp.float32)
        h_dd = jnp.zeros((dd_sketch.n_bins,), jnp.float32)
        s_port = jnp.zeros((), jnp.float32)
        s_dd = jnp.zeros((), jnp.float32)
        start = 0

    end = n_blocks if max_blocks is None else min(n_blocks, start + max_blocks)

    def snapshot(next_block):
        # device -> host ONLY here: each fetch synchronizes with the device,
        # so state is materialized per block only when persisting
        return PathRiskCheckpoint(
            seed=config.seed, n_steps=config.n_steps,
            block_paths=block_paths, n_blocks=n_blocks,
            next_block=next_block,
            h_port=np.asarray(h_port), h_dd=np.asarray(h_dd),
            s_port=np.asarray(s_port), s_dd=np.asarray(s_dd),
            sketch_lo=sketch.lo, sketch_hi=sketch.hi,
            sketch_space=sketch.space, dd_lo=dd_sketch.lo,
            dd_hi=dd_sketch.hi, digest=digest,
        )

    ck = None
    for b in range(start, end):
        block_seed = np.int32(config.seed + (b + 1) * SEED_STRIDE)
        term, dd = block_fn(b, block_seed)
        port, ddv = term[0], dd[0]
        h_port = h_port + histogram(port, sketch)
        h_dd = h_dd + histogram(ddv, dd_sketch)
        s_port = s_port + port.sum()
        s_dd = s_dd + ddv.sum()
        if checkpoint_path is not None:
            ck = snapshot(b + 1)
            ck.save(checkpoint_path)
    if checkpoint_path is None and end > start:
        ck = snapshot(end)
    if ck is None:
        # no block ran: resumed an already-done checkpoint (no-op) or
        # max_blocks == 0 — snapshot the current (possibly empty) state
        ck = checkpoint if checkpoint is not None else snapshot(start)
    v, c = sketch_var_cvar(h_port, alpha, sketch)
    dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch)
    dd_med = sketch_quantile(h_dd, 0.5, dd_sketch)
    n_done = ck.next_block * block_paths
    return PathRiskReport(
        var=float(v), cvar=float(c),
        port_mean=float(s_port) / max(n_done, 1),
        dd_mean=float(s_dd) / max(n_done, 1),
        dd_p95=float(dd_p95), dd_median=float(dd_med), n_paths=n_done,
        tail_ci=(_path_tail_ci(h_port, h_dd, alpha, sketch, dd_sketch, config)
                 if ck.done else None),
    ), ck


def run_resumable_path_risk_with_recovery(
    model: str,
    model_params,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    p_restart: float = 0.2,
    rebalance: bool = True,
    checkpoint_path="path_risk_checkpoint.npz",
    segment_blocks: int = 64,
    max_restarts: int = 3,
) -> PathRiskReport:
    """Elastic path-risk driver for ANY model family: run in checkpointed
    segments and survive transient device aborts (the
    :func:`mcport.engine.mc_engine.run_resumable_mc_with_recovery` protocol
    applied to the path tier). Counter-addressed block streams make recovery
    "reload the last checkpoint and continue" — bit-identical to an
    uninterrupted run regardless of where failures land. ``max_restarts``
    bounds CONSECUTIVE failed segments (progress resets the budget)."""
    import pathlib

    import jax

    checkpoint_path = pathlib.Path(checkpoint_path)
    ck = (load_path_risk_checkpoint(checkpoint_path)
          if checkpoint_path.exists() else None)
    failures = 0
    while True:
        try:
            report, ck = run_resumable_path_risk(
                model, model_params, weights, config, sketch, dd_sketch,
                alpha=alpha, hedge=hedge, s0=s0, p_restart=p_restart,
                rebalance=rebalance, checkpoint=ck,
                checkpoint_path=checkpoint_path, max_blocks=segment_blocks)
            failures = 0
        except jax.errors.JaxRuntimeError:
            failures += 1
            if failures > max_restarts:
                raise
            # device state is gone; resume from the last durable checkpoint
            ck = (load_path_risk_checkpoint(checkpoint_path)
                  if checkpoint_path.exists() else None)
            continue
        if ck.done:
            return report
