"""Top-level API — one import for the whole workflow.

``load → stats → simulate → gbm_risk → forecast`` mirrors the reference app's
tab flow (SURVEY.md §3 call stacks) as plain functions over a :class:`Config`.

``gbm_risk`` dispatches across the engines by config:
- ``qmc="none"``   → the chunked/resumable engine (fused kernel on the GPU,
  lax elsewhere), optionally antithetic;
- ``qmc="sobol"|"halton"`` → quasi-MC: terminal-exact low-discrepancy sampling
  (one Gaussian per path — the variance-optimal estimator for terminal risk);
- ``mesh=...``     → the shard_map path with psum'd moments/sketch (multi-chip).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mcport.config import Config
from mcport.data.pipeline import PriceData, load_universe
from mcport.engine.mc_engine import MCCheckpoint, RiskReport, run_resumable_mc
from mcport.engine.simulate import SimulationOutput, run_simulation
from mcport.models.forecast import HorizonForecast, forecast_prices
from mcport.models.gbm import (
    GBMParams,
    estimate_gbm,
    portfolio_terminal_returns,
)
from mcport.models.qmc import qmc_normals
from mcport.ops.dispatch import use_kernels
from mcport.ops.quantile import auto_sketch, histogram, sketch_var_cvar
from mcport.stats.asset_stats import STAT_COLUMNS, asset_stats_batch

__all__ = [
    "load_universe",
    "compute_stats",
    "simulate",
    "gbm_risk",
    "hedged_tail_risk",
    "american_values",
    "american_settled_tail_risk",
    "path_tail_risk",
    "bootstrap_tail_risk",
    "exact_mv_frontier",
    "exact_cvar_frontier",
    "exact_cdar_frontier",
    "risk_based_weights",
    "compare_tail_risk",
    "sensitivities",
    "forecast",
    "Config",
]


def compute_stats(data: PriceData, config: Config = Config()) -> dict[str, dict[str, float]]:
    """Tab-0 table: {asset: {stat: value}} (app.py:463-497)."""
    stats = asset_stats_batch(
        data.stats_rets.T, data.ann_factor, config.portfolio.risk_free
    )
    return {
        name: {k: float(stats[k][i]) for k in STAT_COLUMNS}
        for i, name in enumerate(data.names)
    }


def simulate(
    data: PriceData, config: Config = Config(), legs_by_asset=None, methods=None
) -> SimulationOutput:
    """Tab-2 random-weight search (thin alias of engine.run_simulation)."""
    kwargs = {} if methods is None else {"methods": methods}
    return run_simulation(data, config, legs_by_asset=legs_by_asset, **kwargs)


def gbm_risk(
    data: PriceData | GBMParams,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    mesh=None,
    checkpoint=None,
    checkpoint_path=None,
    legs_by_asset=None,
) -> RiskReport:
    """Correlated-GBM tail risk for one portfolio, engine chosen by config.

    ``mesh`` alone → the one-shot shard_map engine; ``mesh`` plus
    ``checkpoint``/``checkpoint_path`` → the sharded resumable engine
    (:mod:`mcport.parallel.sharded_resumable`; checkpoint must be a
    ShardedMCCheckpoint). Without a mesh, checkpoints use the single-chip
    resumable engine (MCCheckpoint).

    ``legs_by_asset`` ({asset name/index: Legs or reference-style rows})
    makes the PORTFOLIO tail statistics hedged: option legs settle at
    intrinsic value against the simulated terminal prices (terminal
    composition of app.py:164-180 — the simulated-tier counterpart of the
    reference's historical hedged series, app.py:657-667). Asset mean/cov
    stay the plain log-return moments."""
    params = data if isinstance(data, GBMParams) else estimate_gbm(data.prices)
    a = params.n_assets
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    if w.shape != (a,):
        raise ValueError(f"weights must have shape ({a},)")
    g = config.gbm
    alpha = config.simulation.alpha
    hedge = None
    if legs_by_asset:
        from mcport.options.hedged import HedgeSpec

        names = (data.names if isinstance(data, PriceData)
                 else [f"asset{i}" for i in range(a)])
        hedge = HedgeSpec.build(legs_by_asset, names)
    # GBMConfig.auto_sketch (default True) derives the adaptive log1p range
    # from the fitted params; set it False to use Config.sketch verbatim
    # (e.g. to reproduce fixed-grid bin geometry).
    sketch = None if g.auto_sketch else config.sketch

    if mesh is not None and g.qmc != "none":
        raise ValueError(
            "qmc sampling is single-chip only (the sharded engines draw "
            "pseudo-random counter-addressed streams); drop mesh= or set "
            "qmc='none'")

    if hedge is not None and mesh is not None:
        if (checkpoint is not None or checkpoint_path is not None
                or g.innovations != "normal" or g.antithetic):
            # the sharded RESUMABLE engine carries the full option surface
            # (checkpoints, student_t, antithetic) with hedged settlement —
            # bit-identical to the single-chip hedged engine's block grid
            from mcport.parallel.sharded_resumable import run_sharded_resumable_mc

            report, _ = run_sharded_resumable_mc(
                params, w, mesh, g, sketch, alpha=alpha,
                checkpoint=checkpoint, checkpoint_path=checkpoint_path,
                hedge=hedge,
            )
            return report
        from mcport.parallel.sharded_engines import sharded_hedged_gbm_risk

        v, c, pm = sharded_hedged_gbm_risk(
            g.seed, params, w, hedge, n_paths=g.n_paths, n_steps=g.n_steps,
            mesh=mesh, alpha=alpha, sketch=sketch,
        )
        return RiskReport(
            # analytic moments (mean/cov are not sampled on this path)
            mean=np.asarray(params.mean_step) * g.n_steps,
            cov=(np.asarray(params.chol_step) @ np.asarray(params.chol_step).T
                 * g.n_steps),
            var=float(v), cvar=float(c), port_mean=float(pm), n_paths=g.n_paths,
        )

    if mesh is not None and (checkpoint is not None or checkpoint_path is not None):
        # sharded + resumable composition (per-device cursors, bit-exact resume)
        from mcport.parallel.sharded_resumable import run_sharded_resumable_mc

        report, _ = run_sharded_resumable_mc(
            params, w, mesh, g, sketch, alpha=alpha,
            checkpoint=checkpoint, checkpoint_path=checkpoint_path,
        )
        return report

    if mesh is not None:
        from mcport.parallel.sharded_mc import sharded_gbm_risk

        out = sharded_gbm_risk(
            g.seed, jnp.asarray(params.mean_step, jnp.dtype(g.dtype)),
            jnp.asarray(params.chol_step, jnp.dtype(g.dtype)),
            jnp.asarray(w, jnp.dtype(g.dtype)),
            n_paths=g.n_paths, n_steps=g.n_steps, mesh=mesh, alpha=alpha,
            sketch=sketch, use_pallas=use_kernels(g.use_pallas),
            antithetic=g.antithetic,
            t_df=g.t_dof if g.innovations == "student_t" else None,
        )
        return RiskReport(
            mean=np.asarray(out.mean), cov=np.asarray(out.cov),
            var=float(out.var), cvar=float(out.cvar),
            port_mean=float(out.port_mean), n_paths=g.n_paths,
        )

    if g.qmc != "none":
        if g.innovations != "normal":
            raise ValueError(
                "QMC sampling draws Gaussian innovations (Sobol/Halton inverse "
                "normal transform); student_t is not supported with qmc != 'none'"
            )
        dtype = jnp.dtype(g.dtype)
        if sketch is None:
            if hedge is not None:
                from mcport.options.hedged import auto_hedged_sketch

                sketch = auto_hedged_sketch(
                    params, g.n_steps, hedge,
                    weights=w if (w >= 0).all() else None)
            else:
                sketch = auto_sketch(params.mean_step, params.chol_step, g.n_steps)
        z = qmc_normals(g.n_paths, a, g.qmc, g.seed, dtype)
        scale = jnp.sqrt(jnp.asarray(g.n_steps, dtype))
        lt = jnp.asarray(params.chol_step, dtype).T
        term = g.n_steps * jnp.asarray(params.mean_step, dtype) + scale * (z @ lt)
        if hedge is not None:
            from mcport.options.hedged import hedged_terminal_returns

            port = hedged_terminal_returns(
                term, jnp.asarray(params.s0, dtype), *hedge.arrays
            ) @ jnp.asarray(w, dtype)
        else:
            port = portfolio_terminal_returns(term, jnp.asarray(w, dtype))
        counts = histogram(port, sketch)
        v, c = sketch_var_cvar(counts, alpha, sketch)
        mean = term.mean(0)
        centred = term - mean
        cov = centred.T @ centred / (g.n_paths - 1)
        return RiskReport(
            mean=np.asarray(mean), cov=np.asarray(cov), var=float(v), cvar=float(c),
            port_mean=float(port.mean()), n_paths=g.n_paths,
        )

    report, _ = run_resumable_mc(
        params, w, g, sketch, alpha=alpha,
        checkpoint=checkpoint, checkpoint_path=checkpoint_path, hedge=hedge,
    )
    return report


def bootstrap_tail_risk(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    p_restart: float = 0.2,
):
    """Distribution-free tail risk by stationary block bootstrap over the
    assembled historical returns (models.bootstrap)."""
    import jax as _jax

    from mcport.models.bootstrap import bootstrap_risk

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    return bootstrap_risk(
        _jax.random.key(g.seed), data.port_rets, w,
        n_paths=g.n_paths, n_steps=g.n_steps, p_restart=p_restart,
        alpha=config.simulation.alpha,
    )


def _family_terminal_simple(data: PriceData, model: str, g, key):
    """(n_paths, A) terminal SIMPLE returns under ``model`` — the shared lax
    draw behind :func:`hedged_tail_risk` and the family Greeks tier."""
    if model == "gbm" or model == "student_t":
        from mcport.models.gbm import (
            estimate_t_dof, terminal_log_returns, terminal_log_returns_t,
        )

        params = estimate_gbm(data.prices)
        m = jnp.asarray(params.mean_step, jnp.float32)
        L = jnp.asarray(params.chol_step, jnp.float32)
        if model == "student_t":
            term_log = terminal_log_returns_t(
                key, m, L, estimate_t_dof(data.prices), g.n_paths, g.n_steps)
        else:
            term_log = terminal_log_returns(key, m, L, g.n_paths, g.n_steps)
        return jnp.expm1(term_log)
    if model == "garch":
        from mcport.models.garch_mc import estimate_ccc_garch, garch_terminal_returns

        gparams = estimate_ccc_garch(data.port_rets)
        return garch_terminal_returns(key, gparams, g.n_paths, g.n_steps)
    if model == "dcc":
        from mcport.models.dcc import dcc_terminal_returns, estimate_dcc_garch

        return dcc_terminal_returns(key, estimate_dcc_garch(data.port_rets),
                                    g.n_paths, g.n_steps)
    if model == "jump":
        from mcport.models.jump import estimate_merton_common, merton_terminal_returns

        mp = estimate_merton_common(data.prices)
        term_log = merton_terminal_returns(
            key, mp.diffusion.mean_step, mp.diffusion.chol_step,
            mp.jump_rate, mp.jump_mean, mp.jump_vol, g.n_paths, g.n_steps)
        return jnp.expm1(term_log)
    if model == "heston":
        from mcport.models.heston import estimate_heston, heston_terminal_returns

        return heston_terminal_returns(key, estimate_heston(data.prices),
                                       g.n_paths, g.n_steps)
    if model == "bootstrap":
        from mcport.models.bootstrap import bootstrap_terminal_returns

        return bootstrap_terminal_returns(
            key, jnp.asarray(data.port_rets, jnp.float32), g.n_paths, g.n_steps)
    raise ValueError(
        f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', 'heston' "
        f"or 'bootstrap', got {model!r}")


def hedged_tail_risk(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    legs_by_asset=None,
    model: str = "gbm",
) -> dict[str, float]:
    """Hedged portfolio tail risk under any terminal model family.

    Draws (n_paths, A) terminal simple returns from ``model`` ("gbm",
    "student_t", "garch", "dcc", "jump", "heston", "bootstrap"), settles
    each asset's
    option legs at
    intrinsic value against the implied terminal price (terminal composition
    of app.py:164-180; see :mod:`mcport.options.hedged`), and reports exact
    top-k tail metrics of the hedged portfolio — {var, cvar, port_mean,
    hedged: True}. The k-worst convention matches the simulated frontier
    (k = ceil((1-alpha)·n_paths); VaR = k-th worst, CVaR = k-worst mean).

    This is the one-stop hedged counterpart of :func:`compare_tail_risk`'s
    families on their lax paths; ``gbm_risk(legs_by_asset=...)`` remains the
    chunked/resumable form for huge path counts.
    """
    from mcport.options.hedged import HedgeSpec, hedged_from_simple

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    alpha = config.simulation.alpha
    spec = HedgeSpec.build(legs_by_asset, data.names)
    s0 = np.asarray(data.prices[-1], np.float64)
    key = jax.random.key(g.seed)

    simple = _family_terminal_simple(data, model, g, key)

    hedged = hedged_from_simple(
        simple, jnp.asarray(s0, simple.dtype), *spec.arrays)
    port = hedged @ jnp.asarray(w, hedged.dtype)
    import math as _math

    k = max(1, _math.ceil((1.0 - alpha) * g.n_paths))
    worst, _ = jax.lax.top_k(-port, k)
    out = {
        "var": float(-worst[-1]),
        "cvar": float(-worst.mean()),
        "port_mean": float(port.mean()),
        "model": model,
        "n_paths": g.n_paths,
        "hedged_assets": [n for n, m_ in zip(data.names, spec.hedged_mask) if m_],
    }
    if getattr(g, "ci_boot", 0) > 0:
        # exact-tier error bars: the terminals ARE materialized here, so the
        # bootstrap resamples paths directly (top_k per replicate, unbinned)
        from mcport.ops.quantile import sample_var_cvar_ci, tail_ci_fields

        out["tail_ci"] = tail_ci_fields(sample_var_cvar_ci(
            port, alpha, n_boot=int(g.ci_boot), seed=g.seed))
    return out


def american_values(
    data: PriceData,
    config: Config = Config(),
    strike_rel: float = 1.0,
    kind: str = "put",
    rate_annual: float = 0.03,
    div_annual: float = 0.0,
    greeks: bool = False,
) -> dict[str, dict[str, float]]:
    """Per-asset American option values (Longstaff-Schwartz; see
    :mod:`mcport.options.american`). Vol comes from the estimated per-step
    law, strikes sit at ``strike_rel`` × spot, the per-step risk-free log
    rate is ``log1p(rate_annual)/ann_factor`` (likewise ``div_annual``).
    Returns
    {asset: {american, se, european, early_exercise_premium, boundary_last}};
    ``greeks=True`` adds policy-frozen pathwise ``delta`` and ``vega_step``.
    """
    from mcport.models.gbm import estimate_gbm
    from mcport.options.american import american_greeks, american_value

    g = config.gbm
    params = estimate_gbm(data.prices)
    sigma_step = np.sqrt(np.einsum("ij,ij->i", params.chol_step,
                                   params.chol_step))
    spots = np.asarray(data.prices[-1], np.float64)
    rate_step = float(np.log1p(rate_annual) / data.ann_factor)
    pol = american_value(
        g.seed, spots, sigma_step, spots * strike_rel, is_put=kind == "put",
        rate_step=rate_step, n_paths=g.n_paths, n_steps=g.n_steps,
        div_step=float(np.log1p(div_annual) / data.ann_factor))
    out = {
        name: {
            "american": float(pol.value[i]),
            "se": float(pol.se[i]),
            "european": float(pol.european[i]),
            "early_exercise_premium": float(pol.early_premium[i]),
            "boundary_last": float(pol.boundary[i, -1]),
        }
        for i, name in enumerate(data.names)
    }
    if greeks:
        gk = american_greeks(pol, g.seed, spots, sigma_step,
                             div_step=float(np.log1p(div_annual)
                                            / data.ann_factor),
                             n_paths=g.n_paths)
        for i, name in enumerate(data.names):
            out[name]["delta"] = float(gk.delta[i])
            out[name]["vega_step"] = float(gk.vega[i])
    return out


def american_settled_tail_risk(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    legs_by_asset=None,
    rate_annual: float = 0.03,
) -> dict:
    """Tail risk of the AMERICAN-settled hedged book vs European settlement
    of the same paths (:func:`mcport.options.american.american_hedged_tail_risk`
    over the estimated physical law). The American/European split isolates
    the early-exercise effect path-by-path."""
    from mcport.models.gbm import estimate_gbm
    from mcport.options.american import american_hedged_tail_risk
    from mcport.options.hedged import HedgeSpec

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(
        weights, np.float64)
    g = config.gbm
    spec = HedgeSpec.build(legs_by_asset, data.names)
    out = american_hedged_tail_risk(
        estimate_gbm(data.prices), w, spec,
        rate_step=float(np.log1p(rate_annual) / data.ann_factor),
        alpha=config.simulation.alpha, n_paths=g.n_paths, n_steps=g.n_steps,
        seed=g.seed)
    out["exercise_frequency"] = dict(
        zip(data.names, map(float, out["exercise_frequency"])))
    out["hedged_assets"] = [n for n, m_ in zip(data.names, spec.hedged_mask)
                            if m_]
    return out


def path_tail_risk(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    model: str = "gbm",
    legs_by_asset=None,
    p_restart: float = 0.2,
    rebalance: bool = True,
    checkpoint=None,
    checkpoint_path=None,
    max_blocks: int | None = None,
) -> dict[str, float]:
    """Per-period PATH risk for one portfolio under any path model family:
    terminal VaR/CVaR plus the simulated max-drawdown distribution.

    The path-dependent counterpart of :func:`hedged_tail_risk` /
    :func:`compare_tail_risk`: where those settle at the horizon, this
    evolves full paths and reports {var, cvar, port_mean, dd_mean,
    dd_median, dd_p95, model, n_paths} from the fused path-stats engines
    (mcport.engine.path_risk; fused kernels on the GPU for gbm). ``model`` is "gbm"
    (correlated log-normal, ``rebalance`` selects buy-and-hold vs per-period
    rebalancing — GARCH/bootstrap are inherently rebalanced), "student_t"
    (GBM drift/covariance with unit-variance Student-t shocks at the
    moment-fitted dof — fat tails), "garch" (CCC-GARCH(1,1), volatility
    clustering), "dcc" (DCC-GARCH: correlations that RISE in stress), "jump"
    (common-jump Merton: systemic crashes hit every asset at once,
    threshold-calibrated), "heston" (stochastic volatility: per-asset CIR
    variance diffusions with leverage correlation, moment-matched) or
    "bootstrap" (stationary block bootstrap of the
    history, distribution-free). The reference
    computes drawdown only on historical returns (app.py:252-256); this is
    its forward-looking simulated extension.

    ``legs_by_asset`` switches every family to HEDGED per-period option
    settlement against the simulated price path (app.py:164-193 semantics,
    per step; see :mod:`mcport.options.hedged`).

    ``checkpoint`` / ``checkpoint_path`` / ``max_blocks`` route through the
    resumable block-cursor driver
    (:func:`mcport.engine.path_risk.run_resumable_path_risk` — bit-identical
    to the one-shot engines); the output gains a ``done`` flag.
    """
    from mcport.engine.path_risk import (
        run_bootstrap_path_risk, run_garch_path_risk, run_path_risk,
    )
    from mcport.options.hedged import HedgeSpec

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    alpha = config.simulation.alpha
    spec = (None if legs_by_asset is None
            else HedgeSpec.build(legs_by_asset, data.names))
    s0 = np.asarray(data.prices[-1], np.float64)

    # estimate the family parameters from the universe
    import dataclasses

    if model == "gbm" or model == "student_t":
        model_params = estimate_gbm(data.prices)
        if model == "student_t":
            from mcport.models.gbm import estimate_t_dof

            g = dataclasses.replace(g, innovations="student_t",
                                    t_dof=estimate_t_dof(data.prices))
    elif model == "garch":
        from mcport.models.garch_mc import estimate_ccc_garch

        model_params = estimate_ccc_garch(data.port_rets)
    elif model == "dcc":
        from mcport.models.dcc import estimate_dcc_garch

        model_params = estimate_dcc_garch(data.port_rets)
    elif model == "jump":
        from mcport.models.jump import estimate_merton_common

        model_params = estimate_merton_common(data.prices)
    elif model == "heston":
        from mcport.models.heston import estimate_heston

        model_params = estimate_heston(data.prices)
    elif model == "bootstrap":
        model_params = data.port_rets
    else:
        raise ValueError(
            f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', "
            f"'heston' or 'bootstrap', got {model!r}")

    resumable = (checkpoint is not None or checkpoint_path is not None
                 or max_blocks is not None)
    done = True
    if resumable:
        # block-cursor checkpointing across every family (the resumable
        # driver is bit-identical to the one-shot engines — tested)
        from mcport.engine.path_risk import run_resumable_path_risk

        rep, ck = run_resumable_path_risk(
            model, model_params, w, g, alpha=alpha, hedge=spec, s0=s0,
            p_restart=p_restart, rebalance=rebalance, checkpoint=checkpoint,
            checkpoint_path=checkpoint_path, max_blocks=max_blocks)
        done = ck.done
    elif model == "gbm" or model == "student_t":
        rep = run_path_risk(model_params, w, g, alpha=alpha,
                            rebalance=rebalance, hedge=spec)
    elif model == "garch":
        rep = run_garch_path_risk(model_params, w, g, alpha=alpha, hedge=spec,
                                  s0=s0)
    elif model == "dcc":
        from mcport.engine.path_risk import run_dcc_path_risk

        rep = run_dcc_path_risk(model_params, w, g, alpha=alpha, hedge=spec,
                                s0=s0)
    elif model == "jump":
        from mcport.engine.path_risk import run_merton_path_risk

        rep = run_merton_path_risk(model_params, w, g, alpha=alpha, hedge=spec)
    elif model == "heston":
        from mcport.engine.path_risk import run_heston_path_risk

        rep = run_heston_path_risk(model_params, w, g, alpha=alpha, hedge=spec)
    else:
        rep = run_bootstrap_path_risk(data.port_rets, w, g,
                                      p_restart=p_restart, alpha=alpha,
                                      hedge=spec, s0=s0)

    out = {
        "var": rep.var, "cvar": rep.cvar, "port_mean": rep.port_mean,
        "dd_mean": rep.dd_mean, "dd_median": rep.dd_median,
        "dd_p95": rep.dd_p95, "model": model, "n_paths": rep.n_paths,
    }
    if resumable:
        out["done"] = done
    if rep.tail_ci is not None:
        out["tail_ci"] = rep.tail_ci
    if model == "student_t":
        out["t_dof"] = g.t_dof
    if spec is not None:
        out["hedged_assets"] = [
            n for n, m_ in zip(data.names, spec.hedged_mask) if m_]
    return out


def exact_mv_frontier(
    data: PriceData,
    config: Config = Config(),
    n_lambda: int = 64,
):
    """Exact box-constrained mean-variance frontier over the assembled returns
    (engine.frontier_opt; PGD QP sweep)."""
    from mcport.engine.frontier_opt import exact_frontier

    rets = data.port_rets
    mean_ann = rets.mean(axis=0) * data.ann_factor
    cov_ann = np.atleast_2d(np.cov(rets, rowvar=False, ddof=1)) * data.ann_factor
    pc = config.portfolio
    a = len(data.names)
    min_w = np.zeros(a) if pc.min_weights is None else np.asarray(pc.min_weights)
    max_w = np.ones(a) if pc.max_weights is None else np.asarray(pc.max_weights)
    return exact_frontier(mean_ann, cov_ann, min_w, max_w,
                          risk_free=pc.risk_free, n_lambda=n_lambda)


def exact_cvar_frontier(
    data: PriceData,
    config: Config = Config(),
    scenarios: str = "simulated",
    n_lambda: int = 33,
):
    """Exact mean-CVaR frontier (Rockafellar-Uryasev PGD sweep over scenarios).

    ``scenarios="simulated"`` draws correlated-GBM terminal returns from the
    estimated universe (``config.gbm`` controls paths/steps/seed) — the exact
    counterpart of the random simulated-frontier search.
    ``scenarios="historical"`` optimizes against the assembled per-period
    return rows (the reference's historical-CVaR convention, app.py:258-263,
    with top-k tail means in place of percentile interpolation).
    """
    import jax as _jax

    from mcport.engine.cvar_opt import cvar_frontier, simulated_cvar_frontier

    pc = config.portfolio
    a = len(data.names)
    min_w = np.zeros(a) if pc.min_weights is None else np.asarray(pc.min_weights)
    max_w = np.ones(a) if pc.max_weights is None else np.asarray(pc.max_weights)
    alpha = config.simulation.alpha
    if scenarios == "simulated":
        g = config.gbm
        params = estimate_gbm(data.prices)
        return simulated_cvar_frontier(
            _jax.random.key(g.seed), params, n_paths=g.n_paths, n_steps=g.n_steps,
            alpha=alpha, min_weights=min_w, max_weights=max_w, n_lambda=n_lambda,
        )
    if scenarios == "historical":
        return cvar_frontier(
            data.port_rets, min_w, max_w, alpha=alpha, n_lambda=n_lambda,
        )
    raise ValueError(f"scenarios must be 'simulated' or 'historical', got {scenarios!r}")


def exact_cdar_frontier(
    data: PriceData,
    config: Config = Config(),
    scenarios: str = "historical",
    n_lambda: int = 33,
):
    """Exact mean-CDaR frontier (Chekhlov-Uryasev-Zabarankin PGD sweep).

    ``scenarios="historical"`` (default) optimizes the drawdown of the
    assembled per-period return path — the uncompounded cumulative R·w
    convention matches the reference's historical series (app.py:710).
    ``scenarios="simulated"`` optimizes against one simulated GBM return path
    of ``config.gbm.n_steps`` steps.
    """
    import jax as _jax

    from mcport.engine.cdar_opt import cdar_frontier, simulated_cdar_frontier

    pc = config.portfolio
    a = len(data.names)
    min_w = np.zeros(a) if pc.min_weights is None else np.asarray(pc.min_weights)
    max_w = np.ones(a) if pc.max_weights is None else np.asarray(pc.max_weights)
    alpha = config.simulation.alpha
    if scenarios == "historical":
        return cdar_frontier(data.port_rets, min_w, max_w, alpha=alpha,
                             n_lambda=n_lambda)
    if scenarios == "simulated":
        g = config.gbm
        params = estimate_gbm(data.prices)
        return simulated_cdar_frontier(
            _jax.random.key(g.seed), params, n_steps=g.n_steps, alpha=alpha,
            min_weights=min_w, max_weights=max_w, n_lambda=n_lambda,
        )
    raise ValueError(f"scenarios must be 'historical' or 'simulated', got {scenarios!r}")


def risk_based_weights(
    data: PriceData,
    config: Config = Config(),
    method: str = "erc",
    budgets: Sequence[float] | np.ndarray | None = None,
) -> dict[str, object]:
    """Risk-based allocation over the assembled universe (engine.risk_parity).

    method: "erc" (equal/budgeted risk contributions, Newton on-device),
    "hrp" (hierarchical risk parity), or "ivp" (inverse variance). Returns
    weights plus fractional risk contributions and portfolio volatility, all
    from the reference's annualized moment estimates (app.py:679-680).
    """
    from mcport.engine.risk_parity import (
        hierarchical_risk_parity, inverse_variance, risk_contributions, risk_parity,
    )

    rets = data.port_rets
    cov_ann = np.atleast_2d(np.cov(rets, rowvar=False, ddof=1)) * data.ann_factor
    if method == "erc":
        w = risk_parity(cov_ann, None if budgets is None else np.asarray(budgets))
    elif method == "hrp":
        w = hierarchical_risk_parity(cov_ann)
    elif method == "ivp":
        w = inverse_variance(cov_ann)
    else:
        raise ValueError(f"method must be 'erc', 'hrp' or 'ivp', got {method!r}")
    rc = risk_contributions(w, cov_ann)
    mean_ann = rets.mean(axis=0) * data.ann_factor
    return {
        "method": method,
        "weights": dict(zip(data.names, map(float, w))),
        "risk_contributions": dict(zip(data.names, map(float, rc))),
        "expected_return": float(w @ mean_ann),
        "volatility": float(np.sqrt(max(w @ cov_ann @ w, 0.0))),
    }


def compare_tail_risk(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
) -> dict[str, dict[str, float]]:
    """One portfolio, every model family: {model: {var, cvar, mean}}.

    Runs GBM (normal), GBM (student-t, moment-fitted dof), CCC-GARCH,
    DCC-GARCH, Merton systemic jumps
    (threshold-calibrated), Heston stochastic volatility (moment-matched
    CIR variance with leverage), and the stationary block bootstrap on the same
    universe/weights/config — the risk-model sensitivity view no single
    engine gives. All engines share the path count/horizon from
    ``config.gbm`` and alpha from ``config.simulation``.
    """
    import dataclasses

    import jax as _jax

    from mcport.models.bootstrap import bootstrap_risk
    from mcport.models.garch_mc import estimate_ccc_garch, garch_terminal_returns
    from mcport.models.gbm import estimate_t_dof
    from mcport.models.jump import estimate_merton_common, merton_risk
    from mcport.ops.quantile import histogram as _hist
    from mcport.ops.quantile import sketch_var_cvar as _svc

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    alpha = config.simulation.alpha
    params = estimate_gbm(data.prices)
    out: dict[str, dict[str, float]] = {}

    def pack(var, cvar, mean):
        return {"var": float(var), "cvar": float(cvar),
                "portfolio_mean": float(mean)}

    r = gbm_risk(params, w, config)
    out["gbm_normal"] = pack(r.var, r.cvar, r.port_mean)

    t_cfg = dataclasses.replace(g, innovations="student_t",
                                t_dof=estimate_t_dof(data.prices))
    r = gbm_risk(params, w, dataclasses.replace(config, gbm=t_cfg))
    out["gbm_student_t"] = pack(r.var, r.cvar, r.port_mean)
    out["gbm_student_t"]["t_dof"] = t_cfg.t_dof

    try:
        gparams = estimate_ccc_garch(data.port_rets)
        term = garch_terminal_returns(_jax.random.key(g.seed), gparams,
                                      g.n_paths, g.n_steps)
        port = term @ jnp.asarray(w, term.dtype)
        from mcport.config import COVERING_LOG1P_SKETCH as gsk
        v, c = _svc(_hist(port, gsk), alpha, gsk)
        out["ccc_garch"] = pack(v, c, port.mean())
    except Exception as e:  # degenerate series can break the MLE; keep going
        out["ccc_garch"] = {"error": str(e)}

    try:
        from mcport.models.dcc import dcc_risk, estimate_dcc_garch

        dp = estimate_dcc_garch(data.port_rets)
        v, c, m = dcc_risk(_jax.random.key(g.seed), dp, w,
                           n_paths=g.n_paths, n_steps=g.n_steps, alpha=alpha)
        out["dcc_garch"] = pack(v, c, m)
        out["dcc_garch"]["a_dcc"] = dp.a_dcc
        out["dcc_garch"]["b_dcc"] = dp.b_dcc
    except Exception as e:
        out["dcc_garch"] = {"error": str(e)}

    jparams = estimate_merton_common(data.prices)
    jr = merton_risk(_jax.random.key(g.seed), jparams, w,
                     n_paths=g.n_paths, n_steps=g.n_steps, alpha=alpha)
    out["merton_jump"] = pack(jr.var, jr.cvar, jr.port_mean)
    out["merton_jump"]["jump_rate_per_step"] = jparams.jump_rate

    try:
        from mcport.models.heston import estimate_heston, heston_terminal_returns

        hp = estimate_heston(data.prices)
        term = heston_terminal_returns(_jax.random.key(g.seed), hp,
                                       g.n_paths, g.n_steps)
        port = term @ jnp.asarray(w, term.dtype)
        from mcport.config import COVERING_LOG1P_SKETCH as hsk
        v, c = _svc(_hist(port, hsk), alpha, hsk)
        out["heston"] = pack(v, c, port.mean())
        out["heston"]["mean_kappa"] = float(np.mean(hp.kappa))
        out["heston"]["mean_xi"] = float(np.mean(hp.xi))
    except Exception as e:  # degenerate series; keep going like the GARCHes
        out["heston"] = {"error": str(e)}

    br = bootstrap_risk(_jax.random.key(g.seed), data.port_rets, w,
                        n_paths=g.n_paths, n_steps=g.n_steps, alpha=alpha)
    out["block_bootstrap"] = pack(br.var, br.cvar, br.port_mean)
    return out


def sensitivities(
    data: PriceData,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    legs_by_asset=None,
    gamma: bool = False,
    model: str = "gbm",
) -> dict:
    """Pathwise Greeks of the simulated terminal portfolio via AD
    (:mod:`mcport.engine.greeks`): per-asset ∂(mean, VaR, CVaR)/∂weight,
    drift sensitivities, relative-vol vegas, and — with ``legs_by_asset`` —
    spot deltas of the hedged book (options settle at intrinsic against the
    simulated terminal prices). One reverse pass per metric, not 2·K bumped
    re-simulations; the reference has no sensitivity analytics at all
    (its optimum is a sampled-weight pick, app.py:699-747).
    """
    from mcport.engine.greeks import portfolio_sensitivities
    from mcport.options.hedged import HedgeSpec

    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    hedge = (HedgeSpec.build(legs_by_asset, data.names)
             if legs_by_asset else None)
    if gamma and hedge is None:
        raise ValueError("gamma=True requires legs_by_asset (the gamma of an "
                         "unhedged asset's mean return is structurally 0)")
    if model != "gbm":
        # family tier: every model supports the weight (and hedged spot)
        # gradients — the terminal matrix differentiates in the portfolio
        # composition and the option settlement even where the fitted model
        # parameters are not reparameterizable the way GBM's are
        from mcport.engine.greeks import terminal_sensitivities

        if gamma:
            raise ValueError("LR gamma needs the Gaussian terminal score; "
                             "model='gbm' only")
        simple = _family_terminal_simple(
            data, model, config.gbm, jax.random.key(config.gbm.seed))
        fam = terminal_sensitivities(
            simple, w, alpha=config.simulation.alpha, hedge=hedge,
            s0=(np.asarray(data.prices[-1], np.float64)
                if hedge is not None else None))
        result = {
            "model": model,
            "mean": fam.mean, "var": fam.var, "cvar": fam.cvar,
            "alpha": fam.alpha, "hedged": hedge is not None,
            "euler_gap_var": fam.euler_gap_var,
            "euler_gap_cvar": fam.euler_gap_cvar,
            "d_mean_dw": dict(zip(data.names, fam.d_mean_dw)),
            "d_var_dw": dict(zip(data.names, fam.d_var_dw)),
            "d_cvar_dw": dict(zip(data.names, fam.d_cvar_dw)),
        }
        if hedge is not None:
            result["delta_mean"] = dict(zip(data.names, fam.d_mean_ds0))
            result["delta_cvar"] = dict(zip(data.names, fam.d_cvar_ds0))
        return result
    params = estimate_gbm(data.prices)
    out = portfolio_sensitivities(
        params, w, config.gbm, alpha=config.simulation.alpha, hedge=hedge,
        s0=(np.asarray(data.prices[-1], np.float64)
            if hedge is not None else None))
    base = getattr(out, "base", out)
    result = {
        "model": "gbm",
        "mean": base.mean, "var": base.var, "cvar": base.cvar,
        "alpha": base.alpha, "hedged": hedge is not None,
        "euler_gap_var": base.euler_gap_var,
        "euler_gap_cvar": base.euler_gap_cvar,
        "d_mean_dw": dict(zip(data.names, base.d_mean_dw)),
        "d_var_dw": dict(zip(data.names, base.d_var_dw)),
        "d_cvar_dw": dict(zip(data.names, base.d_cvar_dw)),
        "d_cvar_dmu": dict(zip(data.names, base.d_cvar_dmu)),
        "vega_mean": dict(zip(data.names, base.d_mean_dvol)),
        "vega_cvar": dict(zip(data.names, base.d_cvar_dvol)),
    }
    if hedge is not None:
        result["delta_mean"] = dict(zip(data.names, out.d_mean_ds0))
        result["delta_cvar"] = dict(zip(data.names, out.d_cvar_ds0))
        if gamma:
            from mcport.engine.greeks import hedged_mean_gamma

            gam, gse = hedged_mean_gamma(
                params, w, hedge, np.asarray(data.prices[-1], np.float64),
                config.gbm)
            result["gamma_mean"] = dict(zip(data.names, gam))
            result["gamma_se"] = dict(zip(data.names, gse))
    return result


def forecast(
    data: PriceData, config: Config = Config()
) -> Mapping[str, Mapping[int, HorizonForecast]]:
    """Tab-3 forecasts for every asset (app.py:785-809)."""
    return {
        name: forecast_prices(data.prices[:, i], config.forecast)
        for i, name in enumerate(data.names)
    }
