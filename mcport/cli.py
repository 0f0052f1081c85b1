"""Command-line interface.

The reference has no CLI (its only entry point is ``streamlit run app.py``,
Procfile:1); this is the batch/automation surface the rebuild adds. Every command
consumes the same CSV universe the UI does and emits JSON (machine-readable,
SURVEY.md §5 observability).

Commands:
  stats      per-asset statistics table (tab 0)
  simulate   random-weight portfolio search, all methods (tab 2)
  gbm-risk     correlated-GBM tail risk with the chunked/resumable engine
               (--path-stats adds the simulated max-drawdown distribution)
  exact-frontier exact box-constrained mean-variance frontier (PGD QP)
  cvar-frontier exact mean-CVaR frontier (Rockafellar-Uryasev) over simulated
               or historical scenarios
  cdar-frontier exact mean-CDaR frontier (Chekhlov-Uryasev-Zabarankin) over
               the historical or a simulated return path
  risk-parity  risk-based allocation: ERC (budgeted Newton), HRP, inverse var
  tail-risk    deep-tail VaR/CVaR (importance sampling, alpha 0.9999+)
  compare-models one portfolio, every tail-risk model family
  jump-risk    Merton systemic-jump tail risk (threshold-calibrated)
  bootstrap-risk distribution-free tail risk from resampled historical paths
  hedged-risk  hedged tail risk across model families (--hedge JSON config;
               option legs settle against simulated terminal prices)
  path-risk    per-period path risk across model families: terminal VaR/CVaR
               + simulated max-drawdown distribution (--hedge: per-period
               option settlement)
  sim-frontier weight search scored against simulated GBM paths
               (--hedge scores hedged candidates)
  dd-frontier  max return subject to a simulated max-drawdown budget
               (--hedge: per-period-settled hedged drawdowns)
  american     per-asset American option values + exercise boundaries
               (Longstaff-Schwartz regression over risk-neutral paths)
  backtest     walk-forward out-of-sample comparison of allocation rules
  stress       scenario stress test (shocked-parameter risk deltas)
  bl-frontier  Black-Litterman posterior + exact frontier (views blending)
  forecast     ARIMA(1,1,1)+GARCH(1,1) price forecasts (tab 3)
  serve        JSON-over-HTTP daemon exposing every command above from ONE
               long-lived process (compile-once serve-many; mcport/serve.py)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mcport.config import (
    Config,
    DataConfig,
    ForecastConfig,
    GBMConfig,
    PortfolioConfig,
    SimulationConfig,
)


# Paths per engine block for gbm-risk and path-risk: 1,048,576 paths x 15
# assets of float32 is a 63 MB block, enough path blocks to fill every SM of
# the GPU in one kernel launch.
_ENGINE_BLOCK = 1 << 20


def _round_paths(n: int, block: int = 8_192) -> int:
    """Round a user path count up to a whole number of engine blocks."""
    return -(-n // block) * block


def _universe(args):
    from mcport.data import load_universe

    return load_universe(paths=args.csv, config=DataConfig(period=args.period),
                         loader=getattr(args, "loader", "csv"))


def _emit(obj) -> None:
    json.dump(obj, sys.stdout, indent=2, default=float)
    sys.stdout.write("\n")


def _hedge_from_args(args, d):
    """(legs_by_asset, HedgeSpec) from ``--hedge FILE``, or (None, None).

    The file is the JSON schema of :func:`mcport.options.hedged.legs_from_spec`;
    strategy strikes default relative to each asset's LAST price (spot), the
    reference's tab-1 convention (app.py:515-581)."""
    path = getattr(args, "hedge", None)
    if not path:
        return None, None
    from pathlib import Path

    from mcport.options.hedged import HedgeSpec, legs_from_spec

    try:
        spec_map = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"--hedge {path}: {e}")
    try:
        legs = legs_from_spec(spec_map, d.names, d.prices[-1])
        return legs, HedgeSpec.build(legs, d.names)
    except ValueError as e:
        raise SystemExit(f"--hedge {path}: {e}")


def _estimate_from_args(args, d):
    """estimate_gbm honoring the --estimator/--ewma-lambda tier flags."""
    from mcport.models.gbm import estimate_gbm

    return estimate_gbm(d.prices, estimator=getattr(args, "estimator", "sample"),
                        ewma_lambda=getattr(args, "ewma_lambda", 0.94))


def cmd_stats(args) -> None:
    from mcport.stats import STAT_COLUMNS, asset_stats_batch

    d = _universe(args)
    stats = asset_stats_batch(d.stats_rets.T, d.ann_factor, args.risk_free)
    table = {
        name: {k: float(stats[k][i]) for k in STAT_COLUMNS}
        for i, name in enumerate(d.names)
    }
    if args.ci:
        # error bars on the reference's own headline numbers: stationary
        # block bootstrap of each asset's historical return series (short
        # crypto histories are exactly where sampling error dominates)
        from mcport.stats import historical_stat_cis

        for i, name in enumerate(d.names):
            table[name]["ci"] = historical_stat_cis(
                d.stats_rets[:, i], risk_free=args.risk_free,
                ann_factor=d.ann_factor, n_boot=args.ci,
                p_restart=args.ci_block_restart)
    _emit({"period": args.period, "ann_factor": d.ann_factor, "stats": table})


def cmd_simulate(args) -> None:
    from mcport.engine import run_simulation
    from mcport.engine.simulate import DEFAULT_METHODS

    d = _universe(args)
    cfg = Config(
        portfolio=PortfolioConfig(risk_free=args.risk_free,
                                  investment_amount=args.investment),
        simulation=SimulationConfig(n_portfolios=args.n_portfolios, seed=args.seed,
                                    target_risk=args.target_risk),
    )
    methods = args.methods.split(",") if args.methods else DEFAULT_METHODS
    legs_by_asset, _ = _hedge_from_args(args, d)
    out = run_simulation(d, cfg, legs_by_asset=legs_by_asset, methods=methods)
    report = {}
    for m, r in out.results.items():
        if r.opt_idx < 0:
            report[m] = {"error": "no constraint-satisfying portfolio"}
            continue
        report[m] = {
            "n_valid": r.n_valid,
            "weights": dict(zip(d.names, map(float, r.opt_weights))),
            "allocation_usd": dict(zip(d.names, map(float, r.allocations(args.investment)))),
            "expected_return_ann": float(r.ret[r.opt_idx]),
            "volatility_ann": float(r.std[r.opt_idx]),
            "metric": float(r.metric[r.opt_idx]),
        }
    _emit({"methods": report, "assets": list(d.names)})


def cmd_gbm_risk(args) -> None:
    from mcport.engine.mc_engine import load_checkpoint, run_resumable_mc
    from mcport.models import estimate_gbm

    d = _universe(args)
    params = _estimate_from_args(args, d)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    t_dof = 6.0
    if args.innovations == "student_t":
        from mcport.models.gbm import estimate_t_dof

        t_dof = estimate_t_dof(d.prices)
        if args.fast_normal:
            print("mcport: --fast-normal is ignored with student_t "
                  "innovations (the t sampler has its own polynomial "
                  "pipeline)", file=sys.stderr)
    block = min(args.paths, _ENGINE_BLOCK)
    n_paths = _round_paths(args.paths, block)
    cfg = GBMConfig(n_paths=n_paths, n_steps=args.steps, seed=args.seed,
                    antithetic=args.antithetic, path_block=block,
                    use_pallas=False if args.no_pallas else None,
                    innovations=args.innovations, t_dof=t_dof,
                    bm=args.fast_normal and "poly_fast" or "poly",
                    ci_boot=args.ci)
    ck = load_checkpoint(args.checkpoint) if args.resume else None
    _, hedge = _hedge_from_args(args, d)
    report, ck_out = run_resumable_mc(
        params, w, cfg, alpha=args.alpha, checkpoint=ck,
        checkpoint_path=args.checkpoint, hedge=hedge,
    )
    out = {
        "n_paths": report.n_paths,
        "horizon_steps": args.steps,
        "innovations": args.innovations
                       + (f" (dof={t_dof:.2f})" if args.innovations != "normal" else ""),
        "weights": dict(zip(d.names, map(float, w))),
        "var": report.var,
        "cvar": report.cvar,
        "portfolio_mean_return": report.port_mean,
        "terminal_log_mean": report.mean.tolist(),
        "done": ck_out.done,
    }
    if report.tail_ci is not None:
        out["tail_ci"] = report.tail_ci
    if hedge is not None:
        out["hedged_assets"] = [
            n for n, m_ in zip(d.names, hedge.hedged_mask) if m_]
        if args.path_stats:
            # hedged per-period-settled drawdown distribution (round 3);
            # student_t innovations flow through cfg (late round 3)
            from mcport.engine.path_risk import run_path_risk

            pr = run_path_risk(params, w, cfg, alpha=args.alpha, hedge=hedge)
            out["max_drawdown"] = {
                "settlement": "per-period hedged",
                "innovations": args.innovations,
                "mean": pr.dd_mean, "median": pr.dd_median,
                "p95_worst": pr.dd_p95,
            }
        if args.attribution:
            out["cvar_attribution"] = (
                "unavailable: attribution decomposes the UNHEDGED linear "
                "portfolio; the var/cvar above are hedged"
            )
        args.path_stats = args.attribution = False
    if args.path_stats:
        # student_t innovations flow through cfg (late round 3)
        from mcport.engine.path_risk import run_path_risk

        pr = run_path_risk(params, w, cfg, alpha=args.alpha)
        out["max_drawdown"] = {
            "innovations": args.innovations,
            "mean": pr.dd_mean, "median": pr.dd_median, "p95_worst": pr.dd_p95,
        }
    if args.attribution and args.innovations != "normal":
        out["cvar_attribution"] = (
            "unavailable: attribution draws normal GBM terminals; the "
            "var/cvar above do use " + args.innovations
        )
    elif args.attribution:
        import jax

        from mcport.engine.attribution import simulated_cvar_attribution

        att_paths = min(n_paths, 262_144)
        att = simulated_cvar_attribution(
            jax.random.key(args.seed), params, w,
            n_paths=att_paths, n_steps=args.steps, alpha=args.alpha,
        )
        out["cvar_attribution"] = {
            # an INDEPENDENT exact top-k draw: its var/cvar are reported so
            # the Euler identity is checkable; the headline cvar above is
            # the streamed sketch estimate over the full (possibly larger,
            # possibly antithetic) run — small MC/sketch deltas are expected
            "var": att.var,
            "cvar": att.cvar,
            "n_paths": att_paths,
            "contributions": dict(zip(d.names, map(float, att.contributions))),
            "shares": dict(zip(d.names, map(float, att.shares))),
            "n_tail_samples": att.n_tail,
        }
    _emit(out)


def cmd_greeks(args) -> None:
    """Pathwise sensitivities of (mean, VaR, CVaR) via AD through the
    simulation (mcport.engine.greeks) — weight gradients, drift/vol
    sensitivities, and per-asset spot deltas of a hedged book."""
    from mcport.engine.greeks import portfolio_sensitivities

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    if args.model != "gbm":
        # family tier: weight + hedged-spot gradients under any terminal law.
        # GBM-path-only flags must not be silently dropped — reject loudly.
        if args.gamma:
            raise SystemExit("--gamma requires --model gbm (Gaussian score)")
        for flag, default, name in ((args.qmc, "none", "--qmc"),
                                    (args.antithetic, False, "--antithetic"),
                                    (args.estimator, "sample", "--estimator"),
                                    (args.innovations, "normal",
                                     "--innovations")):
            if flag != default:
                raise SystemExit(
                    f"{name} applies to --model gbm only (the {args.model} "
                    "family draws with its own fitted sampler)")
        from mcport.api import sensitivities as api_sensitivities

        legs_by_asset, _ = _hedge_from_args(args, d)
        cfg = Config(gbm=GBMConfig(n_paths=args.paths, n_steps=args.steps,
                                   seed=args.seed),
                     simulation=SimulationConfig(alpha=args.alpha))
        fam = api_sensitivities(d, w, cfg, legs_by_asset=legs_by_asset,
                                model=args.model)
        # same per_asset schema as the gbm branch (one consumer contract);
        # the family tier has no drift/vol gradients, so those keys are absent
        per_asset = {
            name: {"weight": float(w[i]),
                   "d_mean_dw": fam["d_mean_dw"][name],
                   "d_var_dw": fam["d_var_dw"][name],
                   "d_cvar_dw": fam["d_cvar_dw"][name]}
            for i, name in enumerate(d.names)
        }
        if fam["hedged"]:
            for name in d.names:
                per_asset[name]["delta_mean"] = fam["delta_mean"][name]
                per_asset[name]["delta_cvar"] = fam["delta_cvar"][name]
        _emit({
            "model": args.model,
            "alpha": args.alpha, "paths": args.paths, "steps": args.steps,
            "hedged": fam["hedged"],
            "mean": fam["mean"], "var": fam["var"], "cvar": fam["cvar"],
            "euler_gap_var": fam["euler_gap_var"],
            "euler_gap_cvar": fam["euler_gap_cvar"],
            "per_asset": per_asset,
        })
        return
    params = _estimate_from_args(args, d)
    t_dof = 6.0
    if args.innovations == "student_t":
        from mcport.models.gbm import estimate_t_dof

        t_dof = estimate_t_dof(d.prices)
    _, hedge = _hedge_from_args(args, d)
    if args.gamma and hedge is None:
        raise SystemExit("--gamma requires --hedge (gamma of an unhedged "
                         "asset's mean return is structurally 0)")
    cfg = GBMConfig(n_paths=args.paths, n_steps=args.steps, seed=args.seed,
                    antithetic=args.antithetic, qmc=args.qmc,
                    innovations=args.innovations, t_dof=t_dof)
    out = portfolio_sensitivities(
        params, w, cfg, alpha=args.alpha, hedge=hedge,
        s0=(d.prices[-1] if hedge is not None else None))
    base = getattr(out, "base", out)
    per_asset = {
        name: {
            "weight": float(w[i]),
            "d_mean_dw": float(base.d_mean_dw[i]),
            "d_var_dw": float(base.d_var_dw[i]),
            "d_cvar_dw": float(base.d_cvar_dw[i]),
            "d_cvar_dmu": float(base.d_cvar_dmu[i]),
            "vega_cvar": float(base.d_cvar_dvol[i]),
            "vega_mean": float(base.d_mean_dvol[i]),
        }
        for i, name in enumerate(d.names)
    }
    if hedge is not None:
        for i, name in enumerate(d.names):
            per_asset[name]["delta_mean"] = float(out.d_mean_ds0[i])
            per_asset[name]["delta_cvar"] = float(out.d_cvar_ds0[i])
        if args.gamma:
            from mcport.engine.greeks import hedged_mean_gamma

            gam, gse = hedged_mean_gamma(params, w, hedge, d.prices[-1], cfg)
            for i, name in enumerate(d.names):
                per_asset[name]["gamma_mean"] = float(gam[i])
                per_asset[name]["gamma_se"] = float(gse[i])
    _emit({
        "model": "gbm",
        "alpha": args.alpha, "paths": base.n_paths, "steps": args.steps,
        "hedged": hedge is not None,
        "mean": base.mean, "var": base.var, "cvar": base.cvar,
        "euler_gap_var": base.euler_gap_var,
        "euler_gap_cvar": base.euler_gap_cvar,
        "per_asset": per_asset,
    })


def cmd_american(args) -> None:
    """American-exercise option pricing per asset (Longstaff-Schwartz over
    risk-neutral simulated paths; mcport.options.american). Vol comes from
    the history under --estimator; the per-step risk-free log rate from
    --rate / ann_factor."""
    from mcport.options.american import american_value

    d = _universe(args)
    params = _estimate_from_args(args, d)
    sigma_step = np.sqrt(np.einsum("ij,ij->i", params.chol_step,
                                   params.chol_step))
    spots = np.asarray(d.prices[-1], np.float64)
    strikes = spots * args.strike_rel
    rate_step = np.log1p(args.rate) / d.ann_factor
    _, spec = _hedge_from_args(args, d)
    if spec is not None:
        # settlement mode: American-vs-European settled hedged book
        from mcport.options.american import american_hedged_tail_risk

        a = d.n_assets
        w = (np.full(a, 1.0 / a) if args.weights is None
             else np.asarray([float(x) for x in args.weights.split(",")]))
        if w.shape[0] != a:
            raise SystemExit(f"--weights needs {a} entries")
        out = american_hedged_tail_risk(
            params, w, spec, rate_step=float(rate_step), alpha=args.alpha,
            n_paths=args.paths, n_steps=args.steps, seed=args.seed)
        _emit({
            "engine": "american-settled hedged book (LSMC thresholds, "
                      "physical-measure paths; identical paths both columns)",
            "alpha": args.alpha,
            "rate_annual": args.rate,
            "paths": args.paths,
            "steps": args.steps,
            "weights": dict(zip(d.names, map(float, w))),
            "american": out["american"],
            "european": out["european"],
            "exercise_frequency": dict(
                zip(d.names, map(float, out["exercise_frequency"]))),
        })
        return
    div_step = float(np.log1p(args.div) / d.ann_factor)
    pol = american_value(
        args.seed, spots, sigma_step, strikes, is_put=args.kind == "put",
        rate_step=float(rate_step), n_paths=args.paths, n_steps=args.steps,
        div_step=div_step)
    bnd = pol.boundary
    per_asset = {
        name: {
            "spot": float(spots[i]),
            "strike": float(strikes[i]),
            "sigma_step": float(sigma_step[i]),
            "american": float(pol.value[i]),
            "se": float(pol.se[i]),
            "european": float(pol.european[i]),
            "early_exercise_premium": float(pol.early_premium[i]),
            "boundary_first": float(bnd[i, 0]),
            "boundary_last": float(bnd[i, -1]),
        }
        for i, name in enumerate(d.names)
    }
    if args.greeks:
        from mcport.options.american import american_greeks

        g = american_greeks(pol, args.seed, spots, sigma_step,
                            div_step=div_step, n_paths=args.paths)
        for i, name in enumerate(d.names):
            per_asset[name]["delta"] = float(g.delta[i])
            per_asset[name]["vega_step"] = float(g.vega[i])
    _emit({
        "engine": "lsmc-american (risk-neutral GBM, cubic moneyness basis)",
        "kind": args.kind,
        "rate_annual": args.rate,
        "paths": args.paths,
        "steps": args.steps,
        "per_asset": per_asset,
    })


def cmd_garch_risk(args) -> None:
    import jax
    import jax.numpy as jnp

    from mcport.config import SketchConfig
    from mcport.models import estimate_ccc_garch, garch_terminal_returns
    from mcport.ops.quantile import histogram, sketch_var_cvar

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    if args.correlation == "dcc":
        from mcport.models.dcc import dcc_risk, estimate_dcc_garch

        if args.innovations != "normal":
            raise SystemExit("--correlation dcc supports normal shocks only")
        dp = estimate_dcc_garch(d.port_rets)
        v, c, m = dcc_risk(jax.random.key(args.seed), dp, w,
                           n_paths=args.paths, n_steps=args.steps,
                           alpha=args.alpha)
        _emit({
            "model": f"dcc-garch(1,1) a={dp.a_dcc:.3f} b={dp.b_dcc:.3f}",
            "n_paths": args.paths,
            "horizon_steps": args.steps,
            "weights": dict(zip(d.names, map(float, w))),
            "var": v, "cvar": c, "portfolio_mean_return": m,
        })
        return
    params = estimate_ccc_garch(d.port_rets)
    t_df = None
    if args.innovations == "student_t":
        from mcport.models.gbm import estimate_t_dof

        t_df = estimate_t_dof(d.prices)
    term = garch_terminal_returns(jax.random.key(args.seed), params,
                                  args.paths, args.steps, t_df=t_df)
    port = term @ jnp.asarray(w, term.dtype)
    from mcport.config import COVERING_LOG1P_SKETCH as sketch  # shared; no clamping

    v, c = sketch_var_cvar(histogram(port, sketch), args.alpha, sketch)
    _emit({
        "model": "ccc-garch(1,1)" + (f"-t(dof={t_df:.2f})" if t_df else ""),
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "weights": dict(zip(d.names, map(float, w))),
        "var": float(v),
        "cvar": float(c),
        "portfolio_mean_return": float(port.mean()),
        "garch_alpha": params.alpha.tolist(),
        "garch_beta": params.beta.tolist(),
    })


def cmd_exact_frontier(args) -> None:
    import jax  # noqa: F401  (backend init consistency with the other commands)

    from mcport.engine.frontier_opt import (
        exact_frontier, max_sharpe_exact, min_variance_exact, target_risk_exact,
    )

    d = _universe(args)
    rets = d.port_rets
    mean_ann = rets.mean(axis=0) * d.ann_factor
    cov_ann = np.cov(rets, rowvar=False, ddof=1) * d.ann_factor
    a = d.n_assets
    min_w = np.full(a, args.min_weight)
    max_w = np.full(a, args.max_weight)
    f = exact_frontier(mean_ann, np.atleast_2d(cov_ann), min_w, max_w,
                       risk_free=args.risk_free, n_lambda=args.n_lambda)

    def pack(sel):
        w, ret, std = sel
        return {"weights": dict(zip(d.names, map(float, w))),
                "expected_return": ret, "volatility": std,
                "sharpe": (ret - args.risk_free) / std if std > 0 else 0.0}

    _emit({
        "engine": "exact-projected-gradient-frontier",
        "n_lambda": args.n_lambda,
        "max_sharpe": pack(max_sharpe_exact(f)),
        "min_variance": pack(min_variance_exact(f)),
        "target_risk": pack(target_risk_exact(f, args.target_risk)),
    })


def cmd_cvar_frontier(args) -> None:
    import jax

    from mcport.api import exact_cvar_frontier
    from mcport.engine.cvar_opt import max_return_at_cvar, min_cvar_exact

    d = _universe(args)
    cfg = Config(
        portfolio=PortfolioConfig(
            risk_free=args.risk_free,
            min_weights=(args.min_weight,) * d.n_assets,
            max_weights=(args.max_weight,) * d.n_assets,
        ),
        simulation=SimulationConfig(alpha=args.alpha),
        gbm=GBMConfig(n_paths=_round_paths(args.paths), n_steps=args.steps,
                      seed=args.seed),
    )
    f = exact_cvar_frontier(d, cfg, scenarios=args.scenarios,
                            n_lambda=args.n_lambda)

    def pack(sel):
        w, ret, cvar = sel
        return {"weights": dict(zip(d.names, map(float, w))),
                "expected_return": ret, "cvar": cvar}

    _emit({
        "engine": "exact-rockafellar-uryasev-frontier",
        "scenarios": args.scenarios,
        "alpha": args.alpha,
        "n_lambda": args.n_lambda,
        "min_cvar": pack(min_cvar_exact(f)),
        "max_return_at_budget": pack(max_return_at_cvar(f, args.cvar_budget)),
        "frontier": [
            {"lam": float(l), "ret": float(r), "cvar": float(c), "std": float(s)}
            for l, r, c, s in zip(f.lams, f.ret, f.cvar, f.std)
        ],
    })


def cmd_cdar_frontier(args) -> None:
    from mcport.api import exact_cdar_frontier
    from mcport.engine.cdar_opt import max_return_at_cdar, min_cdar_exact

    d = _universe(args)
    cfg = Config(
        portfolio=PortfolioConfig(
            risk_free=args.risk_free,
            min_weights=(args.min_weight,) * d.n_assets,
            max_weights=(args.max_weight,) * d.n_assets,
        ),
        simulation=SimulationConfig(alpha=args.alpha),
        gbm=GBMConfig(n_steps=args.steps, seed=args.seed),
    )
    f = exact_cdar_frontier(d, cfg, scenarios=args.scenarios,
                            n_lambda=args.n_lambda)

    def pack(sel):
        w, ret, cdar = sel
        return {"weights": dict(zip(d.names, map(float, w))),
                "expected_return_per_period": ret, "cdar": cdar}

    _emit({
        "engine": "exact-cdar-frontier (chekhlov-uryasev-zabarankin)",
        "scenarios": args.scenarios,
        "alpha": args.alpha,
        "n_lambda": args.n_lambda,
        "min_cdar": pack(min_cdar_exact(f)),
        "max_return_at_budget": pack(max_return_at_cdar(f, args.dd_budget)),
        "frontier": [
            {"lam": float(l), "ret": float(r), "cdar": float(c), "max_dd": float(m)}
            for l, r, c, m in zip(f.lams, f.ret, f.cdar, f.max_dd)
        ],
    })


def cmd_bl_frontier(args) -> None:
    from mcport.engine.black_litterman import black_litterman, posterior_frontier
    from mcport.engine.frontier_opt import max_sharpe_exact, min_variance_exact

    d = _universe(args)
    a = d.n_assets
    names = list(d.names)
    cov_ann = d.cov_ann
    w_mkt = (np.full(a, 1.0 / a) if args.market_weights is None
             else np.asarray([float(x) for x in args.market_weights.split(",")]))
    if w_mkt.shape[0] != a:
        raise SystemExit(f"--market-weights needs {a} entries")

    def find(name):
        exact = [i for i, n in enumerate(names) if name.lower() == n.lower()]
        if len(exact) == 1:
            return exact[0]
        hits = [i for i, n in enumerate(names) if name.lower() in n.lower()]
        if len(hits) == 1:
            return hits[0]
        if not hits:
            raise SystemExit(f"no asset matching {name!r} in {names}")
        raise SystemExit(
            f"{name!r} is ambiguous: matches {[names[i] for i in hits]}")

    rows, targets = [], []
    for v in args.view or []:
        if "=" not in v:
            raise SystemExit(f"--view {v!r}: expected ASSET=Q or LONG>SHORT=Q")
        lhs, q = v.rsplit("=", 1)
        try:
            q = float(q)
        except ValueError:
            raise SystemExit(f"--view {v!r}: target {q!r} is not a number")
        p = np.zeros(a)
        if ">" in lhs:
            lo, sh = lhs.split(">", 1)
            p[find(lo)], p[find(sh)] = 1.0, -1.0
        else:
            p[find(lhs)] = 1.0
        rows.append(p)
        targets.append(q)
    if abs(w_mkt.sum() - 1.0) > 1e-6:
        raise SystemExit(f"--market-weights must sum to 1 (got {w_mkt.sum():.6f})")

    post = black_litterman(
        cov_ann, w_mkt,
        np.asarray(rows) if rows else None,
        np.asarray(targets) if targets else None,
        tau=args.tau, delta=args.delta,
    )
    fr = posterior_frontier(
        post, np.full(a, args.min_weight), np.full(a, args.max_weight),
        risk_free=args.risk_free,
    )

    def pack(sel):
        w, ret, std = sel
        return {"weights": dict(zip(names, map(float, w))),
                "expected_return_ann": ret, "volatility_ann": std}

    _emit({
        "engine": "black-litterman + exact frontier",
        "tau": args.tau, "delta": args.delta,
        "equilibrium_returns_ann": dict(zip(names, map(float, post.pi))),
        "posterior_returns_ann": dict(zip(names, map(float, post.mu))),
        "max_sharpe": pack(max_sharpe_exact(fr)),
        "min_variance": pack(min_variance_exact(fr)),
    })


def cmd_stress(args) -> None:
    from mcport.engine.stress import stress_test
    from mcport.models import estimate_gbm

    d = _universe(args)
    params = _estimate_from_args(args, d)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    crash = None if args.no_crash else (args.crash_rate, args.crash_size)
    if args.path_stats:
        from mcport.engine.stress import path_stress_test

        rep = path_stress_test(params, w, n_paths=args.paths,
                               n_steps=args.steps, alpha=args.alpha,
                               seed=args.seed, crash_jump=crash)
        worst_name, worst = rep.worst("dd_p95")
        _emit({
            "engine": "scenario-stress-paths",
            "weights": dict(zip(d.names, map(float, w))),
            "base": rep.base,
            "scenarios": rep.scenarios,
            "worst_by_dd_p95": {"scenario": worst_name, **worst},
        })
        return
    rep = stress_test(params, w, n_paths=args.paths, n_steps=args.steps,
                      alpha=args.alpha, seed=args.seed, crash_jump=crash)
    worst_name, worst = rep.worst("cvar")
    _emit({
        "engine": "scenario-stress",
        "weights": dict(zip(d.names, map(float, w))),
        "base": rep.base,
        "scenarios": rep.scenarios,
        "worst_by_cvar": {"scenario": worst_name, **worst},
    })


def cmd_backtest(args) -> None:
    from mcport.engine.backtest import walk_forward

    d = _universe(args)
    rules = tuple(args.rules.split(",")) if args.rules else None
    res = walk_forward(
        d.port_rets, window=args.window, horizon=args.horizon, rules=rules,
        risk_free=args.risk_free, ann_factor=d.ann_factor, alpha=args.alpha,
        cost_bps=args.cost_bps, estimator=args.estimator,
        ewma_lambda=args.ewma_lambda,
    )
    _emit({
        "engine": "walk-forward",
        "window": args.window,
        "horizon": args.horizon,
        "n_rebalances": int(len(res.rebal_idx)),
        "oos_periods": int(res.oos_returns.shape[1]),
        "summary": res.summary,
        "final_weights": {
            name: dict(zip(d.names, map(float, res.weights[i, -1])))
            for i, name in enumerate(res.rule_names)
        },
    })


def cmd_risk_parity(args) -> None:
    from mcport.api import risk_based_weights

    d = _universe(args)
    budgets = None
    if args.budgets:
        budgets = np.asarray([float(x) for x in args.budgets.split(",")])
        if len(budgets) != d.n_assets:
            raise SystemExit(
                f"--budgets needs {d.n_assets} comma-separated values, got {len(budgets)}"
            )
    out = risk_based_weights(d, method=args.method, budgets=budgets)
    _emit(out)


def cmd_tail_risk(args) -> None:
    import jax

    from mcport.models import estimate_gbm
    from mcport.models.importance import importance_tail_risk

    d = _universe(args)
    params = _estimate_from_args(args, d)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    out = importance_tail_risk(
        jax.random.key(args.seed), params, w, alpha=args.alpha,
        n_paths=args.paths, n_steps=args.steps,
    )
    _emit({
        "engine": "importance-sampled-tail (exponential tilting)",
        "alpha": args.alpha,
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "weights": dict(zip(d.names, map(float, w))),
        "var": float(out.var),
        "cvar": float(out.cvar),
        "tail_samples": int(out.n_tail_samples),
        "plain_mc_would_have": int(round((1 - args.alpha) * args.paths)),
    })


def cmd_compare_models(args) -> None:
    from mcport.api import compare_tail_risk
    from mcport.config import Config, GBMConfig, SimulationConfig

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    block = min(args.paths, 8192)
    cfg = Config(
        gbm=GBMConfig(n_paths=_round_paths(args.paths, block), n_steps=args.steps,
                      seed=args.seed, path_block=block,
                      use_pallas=False if args.no_pallas else None),
        simulation=SimulationConfig(alpha=args.alpha),
    )
    out = compare_tail_risk(d, w, cfg)
    _emit({
        "engine": "model-comparison",
        "n_paths": cfg.gbm.n_paths,
        "horizon_steps": args.steps,
        "weights": dict(zip(d.names, map(float, w))),
        "models": out,
    })


def cmd_jump_risk(args) -> None:
    import jax

    from mcport.models.jump import estimate_merton_common, merton_risk

    d = _universe(args)
    params = estimate_merton_common(d.prices, threshold=args.threshold)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    out = merton_risk(jax.random.key(args.seed), params, w,
                      n_paths=args.paths, n_steps=args.steps, alpha=args.alpha)
    _emit({
        "engine": "merton-common-jump",
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "calibration": {
            "jump_rate_per_step": params.jump_rate,
            "jump_mean": dict(zip(d.names, map(float, params.jump_mean))),
            "jump_vol": dict(zip(d.names, map(float, params.jump_vol))),
        },
        "weights": dict(zip(d.names, map(float, w))),
        "var": float(out.var),
        "cvar": float(out.cvar),
        "portfolio_mean_return": float(out.port_mean),
        "paths_with_jump_frac": float(out.jump_frac),
    })


def cmd_bootstrap_risk(args) -> None:
    import jax

    from mcport.models.bootstrap import bootstrap_risk

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    out = bootstrap_risk(
        jax.random.key(args.seed), d.port_rets, w,
        n_paths=args.paths, n_steps=args.steps,
        p_restart=args.p_restart, alpha=args.alpha,
    )
    _emit({
        "engine": "stationary-block-bootstrap",
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "expected_block_len": 1.0 / args.p_restart,
        "weights": dict(zip(d.names, map(float, w))),
        "var": float(out.var),
        "cvar": float(out.cvar),
        "portfolio_mean_return": float(out.port_mean),
        "asset_mean_terminal": dict(zip(d.names, map(float, out.mean))),
    })


def cmd_hedged_risk(args) -> None:
    from mcport.api import hedged_tail_risk

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    legs_by_asset, _ = _hedge_from_args(args, d)
    if legs_by_asset is None:
        raise SystemExit("hedged-risk requires --hedge FILE")
    cfg = Config(gbm=GBMConfig(n_paths=args.paths, n_steps=args.steps,
                               seed=args.seed, ci_boot=args.ci),
                 simulation=SimulationConfig(alpha=args.alpha))
    out = {"weights": dict(zip(d.names, map(float, w)))}
    for model in args.models.split(","):
        out[model] = hedged_tail_risk(d, w, cfg, legs_by_asset, model=model)
    _emit(out)


def cmd_path_risk(args) -> None:
    from mcport.api import path_tail_risk

    d = _universe(args)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    legs_by_asset, _ = _hedge_from_args(args, d)
    block = min(args.paths, _ENGINE_BLOCK)
    n_paths = _round_paths(args.paths, block)
    cfg = Config(gbm=GBMConfig(n_paths=n_paths, n_steps=args.steps,
                               seed=args.seed, path_block=block,
                               use_pallas=False if args.no_pallas else None,
                               bm="poly_fast" if args.fast_normal else "poly",
                               ci_boot=args.ci),
                 simulation=SimulationConfig(alpha=args.alpha))
    rebalance = not args.buy_and_hold
    models = args.models.split(",")
    ck = None
    if args.checkpoint and len(models) != 1:
        raise SystemExit("--checkpoint requires a single --models entry")
    if args.resume:
        if not args.checkpoint:
            raise SystemExit("--resume requires --checkpoint FILE")
        from mcport.engine.path_risk import load_path_risk_checkpoint

        ck = load_path_risk_checkpoint(args.checkpoint)
    out = {"weights": dict(zip(d.names, map(float, w))),
           "settlement": ("per-period hedged" if legs_by_asset is not None
                          else "unhedged"),
           "rebalance_gbm": rebalance}
    for model in models:
        out[model] = path_tail_risk(
            d, w, cfg, model=model, legs_by_asset=legs_by_asset,
            p_restart=args.p_restart, rebalance=rebalance,
            checkpoint=ck, checkpoint_path=args.checkpoint or None)
    _emit(out)


def cmd_sim_frontier(args) -> None:
    import jax

    from mcport.engine.simulated_frontier import (
        simulated_weight_search,
        simulated_weight_search_streaming,
    )
    from mcport.models import estimate_gbm

    d = _universe(args)
    params = _estimate_from_args(args, d)
    _, hedge = _hedge_from_args(args, d)
    min_w = np.full(d.n_assets, args.min_weight) if args.min_weight else None
    max_w = np.full(d.n_assets, args.max_weight) if args.max_weight < 1.0 else None
    if args.streaming:
        r = simulated_weight_search_streaming(
            jax.random.key(args.seed), params,
            n_candidates=args.candidates, n_paths=args.paths, n_steps=args.steps,
            objective=args.objective, alpha=args.alpha, risk_free=args.risk_free,
            min_weights=min_w, max_weights=max_w, hedge=hedge,
        )
        _emit({
            "objective": r.objective,
            "n_candidates": r.n_candidates,
            "n_valid": r.n_valid,
            "n_paths": args.paths,
            "streaming": True,
            "hedged": hedge is not None,
            "weights": dict(zip(d.names, map(float, r.opt_weights))),
            "simulated": {
                "expected_return": r.opt_ret,
                "volatility": r.opt_std,
                "metric": r.opt_metric,
            },
        })
        return
    r = simulated_weight_search(
        jax.random.key(args.seed), params,
        n_candidates=args.candidates, n_paths=args.paths, n_steps=args.steps,
        objective=args.objective, alpha=args.alpha, risk_free=args.risk_free,
        min_weights=min_w, max_weights=max_w, hedge=hedge,
    )
    i = r.opt_idx
    _emit({
        "objective": r.objective,
        "n_candidates": args.candidates,
        "n_paths": args.paths,
        "hedged": hedge is not None,
        "weights": dict(zip(d.names, map(float, r.opt_weights))),
        "simulated": {
            "expected_return": float(r.ret[i]),
            "volatility": float(r.std[i]),
            "sharpe": float(r.sharpe[i]),
            "var": float(r.var[i]),
            "cvar": float(r.cvar[i]),
        },
    })


def cmd_dd_frontier(args) -> None:
    import jax

    from mcport.engine.drawdown_frontier import (
        drawdown_frontier_search,
        family_drawdown_frontier_search,
    )
    from mcport.models import estimate_gbm

    d = _universe(args)
    _, hedge = _hedge_from_args(args, d)
    t_dof = None
    if args.model == "gbm":
        if args.innovations == "student_t":
            from mcport.models.gbm import estimate_t_dof

            t_dof = estimate_t_dof(d.prices)
        r = drawdown_frontier_search(
            jax.random.key(args.seed), _estimate_from_args(args, d),
            dd_budget=args.dd_budget,
            n_candidates=args.candidates, n_paths=args.paths,
            n_steps=args.steps, alpha=args.alpha,
            score_dtype=args.score_dtype,
            use_pallas=False if args.no_pallas else None,
            rebalance=args.rebalance, hedge=hedge, t_df=t_dof,
            bm="poly_fast" if args.fast_normal else "poly",
        )
    else:
        if args.fast_normal:
            raise SystemExit("--fast-normal applies to --model gbm only")
        if args.model == "garch":
            from mcport.models.garch_mc import estimate_ccc_garch

            model_params = estimate_ccc_garch(d.port_rets)
        elif args.model == "dcc":
            from mcport.models.dcc import estimate_dcc_garch

            model_params = estimate_dcc_garch(d.port_rets)
        elif args.model == "jump":
            from mcport.models.jump import estimate_merton_common

            model_params = estimate_merton_common(d.prices)
        elif args.model == "heston":
            from mcport.models.heston import estimate_heston

            model_params = estimate_heston(d.prices)
        else:
            model_params = d.port_rets
        r = family_drawdown_frontier_search(
            jax.random.key(args.seed), args.model, model_params,
            dd_budget=args.dd_budget, n_candidates=args.candidates,
            n_paths=args.paths, n_steps=args.steps, alpha=args.alpha,
            hedge=hedge,
            s0=None if hedge is None else np.asarray(d.prices[-1]),
        )
    out = {
        "model": args.model,
        "dd_budget": r.dd_budget,
        "n_candidates": args.candidates,
        "n_feasible": int(r.feasible.sum()),
        "hedged": hedge is not None,
    }
    if t_dof is not None:
        out["innovations"] = f"student_t (dof={t_dof:.2f})"
    if r.opt_idx < 0:
        out["error"] = "no candidate satisfies the drawdown budget"
    else:
        i = r.opt_idx
        out["weights"] = dict(zip(d.names, map(float, r.opt_weights)))
        out["expected_return"] = float(r.ret[i])
        out["dd_p95"] = float(r.dd_p95[i])
    _emit(out)


def cmd_report(args) -> None:
    """Static HTML report: the app's tabs (stats / frontier / forecast)
    rendered dependency-free via mcport.ui.static (round 4 — the UI tier's
    executable path in environments without streamlit)."""
    import pandas as pd

    from mcport.engine import run_simulation
    from mcport.engine.simulate import DEFAULT_METHODS
    from mcport.models import forecast_prices
    from mcport.stats import DISPLAY_COLUMNS, asset_stats_batch
    from mcport.ui.static import render_report
    from mcport.ui.view import forecast_view, frontier_view, payoff_view

    d = _universe(args)
    # tab 1 (app.py:585-653): payoff chart + analysis per hedged asset;
    # purchase price defaults to spot and qty to 1.0 (the app's widget
    # defaults, mcport/ui/app.py)
    legs_by_asset, _ = _hedge_from_args(args, d)
    pviews = {}
    if legs_by_asset:
        for name, legs in legs_by_asset.items():
            spot = float(d.prices[-1, list(d.names).index(name)])
            pviews[name] = payoff_view(legs, purchase_price=spot,
                                       qty_asset=1.0, spot=spot)
    stats = asset_stats_batch(d.stats_rets.T, d.ann_factor, args.risk_free)
    stats_df = pd.DataFrame(
        {k: np.asarray(stats[k]) for k in DISPLAY_COLUMNS}, index=list(d.names))

    cfg = Config(
        portfolio=PortfolioConfig(risk_free=args.risk_free,
                                  investment_amount=args.investment),
        simulation=SimulationConfig(n_portfolios=args.n_portfolios,
                                    seed=args.seed),
    )
    methods = args.methods.split(",") if args.methods else DEFAULT_METHODS
    out = run_simulation(d, cfg, methods=methods)
    fviews = {
        m: frontier_view(m, r, d.names, args.risk_free, args.investment)
        for m, r in out.results.items()
    }

    horizons = tuple(int(h) for h in args.horizons.split(","))
    fc_views = {}
    for i, name in enumerate(d.names):
        f = forecast_prices(d.prices[:, i], ForecastConfig(horizons=horizons))
        fc_views[name] = forecast_view(float(d.prices[-1, i]), f)

    html_doc = render_report(
        stats_df, fviews, fc_views, payoff_views=pviews,
        period_label=args.period, investment=args.investment)
    with open(args.out, "w", encoding="utf-8") as fh:
        fh.write(html_doc)
    _emit({"report": args.out, "bytes": len(html_doc),
           "methods": list(fviews), "assets": list(d.names),
           "hedged_assets": list(pviews)})


def cmd_serve(args) -> None:
    from mcport.serve import serve

    serve(host=args.host, port=args.port)


def cmd_forecast(args) -> None:
    from mcport.models import forecast_prices

    d = _universe(args)
    horizons = tuple(int(h) for h in args.horizons.split(","))
    out = {}
    for i, name in enumerate(d.names):
        f = forecast_prices(d.prices[:, i], ForecastConfig(horizons=horizons))
        out[name] = {
            str(h): {"price": hf.price, "conf_int": list(hf.conf_int),
                     "fallback": hf.fallback}
            for h, hf in f.items()
        }
    _emit({"horizons": list(horizons), "forecasts": out})


def _estimator_flags(sp) -> None:
    sp.add_argument("--estimator", default="sample",
                    choices=["sample", "lw", "ewma"],
                    help="covariance tier: reference sample (ddof=1) | "
                         "Ledoit-Wolf shrinkage (short/wide universes) | "
                         "RiskMetrics EWMA (current-regime risk)")
    sp.add_argument("--ewma-lambda", type=float, default=0.94,
                    help="EWMA decay (only with --estimator ewma)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mcport", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("csv", nargs="+", help="asset CSV files (investing.com/yfinance format)")
        sp.add_argument("--period", default="M", choices=["M", "Q", "W", "D"],
                        help="analysis period (resample rule)")
        sp.add_argument("--risk-free", type=float, default=0.03,
                        help="annual risk-free rate, decimal")
        sp.add_argument("--loader", default="csv", choices=["csv", "native", "auto"],
                        help="CSV parser: csv (standard library, reference "
                             "semantics) or the C++ fast path")

    sp = sub.add_parser("stats", help="per-asset statistics table")
    common(sp)
    sp.add_argument("--ci", type=int, nargs="?", const=500, default=0,
                    metavar="B",
                    help="stationary-block-bootstrap error bars per stat "
                         "(B replicates, default 500)")
    sp.add_argument("--ci-block-restart", type=float, default=0.1,
                    help="bootstrap block restart probability (expected "
                         "block length 1/p; 1.0 = iid bootstrap)")
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("report", help="static HTML report (stats + "
                        "frontier + forecasts; no streamlit needed)")
    common(sp)
    sp.add_argument("--out", default="mcport_report.html")
    sp.add_argument("--n-portfolios", type=int, default=2500)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--investment", type=float, default=10_000.0)
    sp.add_argument("--methods", default=None, help="comma list (default: all six)")
    sp.add_argument("--horizons", default="1,3,6",
                    help="forecast horizons, comma list of periods")
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config file: {asset: {strategy, params} "
                         "| {legs}} — renders the tab-1 payoff chart + "
                         "analysis per hedged asset (app.py:585-653)")
    sp.set_defaults(fn=cmd_report)

    sp = sub.add_parser("simulate", help="random-weight portfolio search")
    common(sp)
    sp.add_argument("--n-portfolios", type=int, default=2500)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--investment", type=float, default=10_000.0)
    sp.add_argument("--target-risk", type=float, default=0.30)
    sp.add_argument("--methods", default=None,
                    help="comma list (default: all six)")
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: {asset: {strategy, params} | "
                         "{legs}} — legs reweight the HISTORICAL return "
                         "series (reference tab-2 semantics, app.py:659-667;"
                         " the simulated-tier settlement lives in gbm-risk/"
                         "sim-frontier/dd-frontier/hedged-risk --hedge)")
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("gbm-risk", help="correlated-GBM tail risk")
    common(sp)
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--antithetic", action="store_true")
    sp.add_argument("--innovations", default="normal", choices=["normal", "student_t"],
                    help="student_t fits dof by method of moments (fat tails)")
    sp.add_argument("--attribution", action="store_true",
                    help="Euler CVaR decomposition: per-asset tail "
                         "contributions (sums exactly to portfolio CVaR)")
    sp.add_argument("--path-stats", action="store_true",
                    help="also simulate full paths for the max-drawdown distribution")
    sp.add_argument("--no-pallas", action="store_true", help="force the lax engine")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws (degree-5 polynomial "
                         "Box-Muller, draw error <=~1.5e-4; kernel path only)")
    sp.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    sp.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: {asset: {strategy, params} | {legs}} — option legs settle against simulated prices (see mcport.options.hedged.legs_from_spec)")
    _estimator_flags(sp)
    sp.add_argument("--ci", type=int, nargs="?", const=200, default=0,
                    metavar="B",
                    help="bootstrap error bars on the reported tail metrics "
                         "(B multinomial resamples of the sketch, default "
                         "200; pure post-processing, streams unchanged)")
    sp.set_defaults(fn=cmd_gbm_risk)

    sp = sub.add_parser(
        "greeks",
        help="pathwise sensitivities by differentiating the simulation "
             "(∂ mean/VaR/CVaR ∂ weights/drift/vol, spot deltas with --hedge)")
    common(sp)
    sp.add_argument("--paths", type=int, default=131_072)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--antithetic", action="store_true")
    sp.add_argument("--innovations", default="normal",
                    choices=["normal", "student_t"])
    sp.add_argument("--qmc", default="none", choices=["none", "sobol", "halton"],
                    help="low-discrepancy terminal draws — variance-reduced "
                         "gradients (Gaussian terminals only)")
    sp.add_argument("--model", default="gbm",
                    choices=["gbm", "student_t", "garch", "dcc", "jump",
                             "heston", "bootstrap"],
                    help="terminal law; non-gbm families report the weight "
                         "(and hedged spot) gradient tier — drift/vol "
                         "sensitivities and gamma are GBM-exact only")
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config (hedged.legs_from_spec schema): "
                         "options settle at intrinsic against simulated "
                         "terminal prices; adds per-asset spot deltas")
    sp.add_argument("--gamma", action="store_true",
                    help="also report per-asset gamma of the hedged mean "
                         "(likelihood-ratio estimator with its standard "
                         "error; requires --hedge, normal innovations)")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_greeks)

    sp = sub.add_parser(
        "american",
        help="per-asset American option values + exercise boundaries "
             "(Longstaff-Schwartz regression over risk-neutral paths)")
    common(sp)
    sp.add_argument("--kind", default="put", choices=["put", "call"])
    sp.add_argument("--strike-rel", type=float, default=1.0,
                    help="strike as a fraction of spot (1.0 = ATM)")
    sp.add_argument("--rate", type=float, default=0.03,
                    help="annual risk-free rate, decimal (sets the "
                         "risk-neutral drift and the discount)")
    sp.add_argument("--div", type=float, default=0.0,
                    help="annual continuous dividend/carry yield, decimal "
                         "(q > 0 makes CALL early exercise optimal)")
    sp.add_argument("--paths", type=int, default=131_072)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: switches to settlement mode — "
                         "tail risk of the American-settled hedged book vs "
                         "European settlement of the SAME paths (option "
                         "legs exercise at fitted LSMC thresholds)")
    sp.add_argument("--weights", default=None,
                    help="portfolio weights, comma list (settlement mode; "
                         "default equal)")
    sp.add_argument("--alpha", type=float, default=0.95,
                    help="tail level (settlement mode)")
    sp.add_argument("--greeks", action="store_true",
                    help="append policy-frozen pathwise delta + per-step "
                         "vega per asset (AD through the stopped paths)")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_american)

    sp = sub.add_parser("garch-risk",
                        help="tail risk under multivariate GARCH(1,1) "
                             "stochastic vol (CCC or DCC correlations)")
    sp.add_argument("--innovations", default="normal",
                    choices=["normal", "student_t"],
                    help="student_t = GARCH-t (moment-fitted dof; lax engine)")
    sp.add_argument("--correlation", default="ccc", choices=["ccc", "dcc"],
                    help="dcc = dynamic conditional correlations (Engle "
                         "two-step QMLE; correlations rise after joint shocks)")
    common(sp)
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.set_defaults(fn=cmd_garch_risk)

    sp = sub.add_parser("exact-frontier",
                        help="exact box-constrained mean-variance frontier (PGD QP)")
    common(sp)
    sp.add_argument("--min-weight", type=float, default=0.0)
    sp.add_argument("--max-weight", type=float, default=1.0)
    sp.add_argument("--n-lambda", type=int, default=64)
    sp.add_argument("--target-risk", type=float, default=0.30)
    sp.set_defaults(fn=cmd_exact_frontier)

    sp = sub.add_parser("risk-parity",
                        help="risk-based allocation: ERC / HRP / inverse variance")
    common(sp)
    sp.add_argument("--method", default="erc", choices=["erc", "hrp", "ivp"])
    sp.add_argument("--budgets", default=None,
                    help="comma-separated risk budgets (erc only; default equal)")
    sp.set_defaults(fn=cmd_risk_parity)

    sp = sub.add_parser("cvar-frontier",
                        help="exact mean-CVaR frontier (Rockafellar-Uryasev PGD)")
    common(sp)
    sp.add_argument("--scenarios", default="simulated",
                    choices=["simulated", "historical"])
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--min-weight", type=float, default=0.0)
    sp.add_argument("--max-weight", type=float, default=1.0)
    sp.add_argument("--n-lambda", type=int, default=33)
    sp.add_argument("--cvar-budget", type=float, default=-0.25,
                    help="tail budget in return convention (e.g. -0.25)")
    sp.add_argument("--paths", type=int, default=16_384)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_cvar_frontier)

    sp = sub.add_parser("cdar-frontier",
                        help="exact mean-CDaR frontier (Chekhlov-Uryasev-"
                             "Zabarankin drawdown PGD)")
    common(sp)
    sp.add_argument("--scenarios", default="historical",
                    choices=["historical", "simulated"])
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--min-weight", type=float, default=0.0)
    sp.add_argument("--max-weight", type=float, default=1.0)
    sp.add_argument("--n-lambda", type=int, default=33)
    sp.add_argument("--dd-budget", type=float, default=0.20,
                    help="CDaR budget as a fraction of wealth (0.20 = 20%%)")
    sp.add_argument("--steps", type=int, default=252,
                    help="simulated-path length (scenarios=simulated)")
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_cdar_frontier)

    sp = sub.add_parser("tail-risk",
                        help="deep-tail VaR/CVaR (alpha up to 0.9999+) by importance sampling")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--alpha", type=float, default=0.9999)
    sp.add_argument("--seed", type=int, default=0)
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_tail_risk)

    sp = sub.add_parser("compare-models",
                        help="one portfolio, every tail-risk model family")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--no-pallas", action="store_true")
    sp.set_defaults(fn=cmd_compare_models)

    sp = sub.add_parser("jump-risk",
                        help="Merton systemic-jump tail risk (threshold-calibrated)")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--threshold", type=float, default=3.0,
                    help="systemic-jump z-score threshold (cross-sectional median)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.set_defaults(fn=cmd_jump_risk)

    sp = sub.add_parser("bootstrap-risk",
                        help="distribution-free tail risk from resampled historical paths")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--p-restart", type=float, default=0.2,
                    help="block restart probability (expected block len = 1/p)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.set_defaults(fn=cmd_bootstrap_risk)

    sp = sub.add_parser("hedged-risk",
                        help="hedged tail risk across model families "
                             "(options settle against simulated prices)")
    common(sp)
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config (required): {asset: {strategy, "
                         "params} | {legs}}")
    sp.add_argument("--models", default="gbm,student_t,garch,dcc,jump,heston,bootstrap",
                    help="comma list of gbm,student_t,garch,dcc,jump,heston,"
                         "bootstrap")
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--ci", type=int, nargs="?", const=200, default=0,
                    metavar="B",
                    help="bootstrap error bars on var/cvar (B exact path "
                         "resamples; pure post-processing)")
    sp.set_defaults(fn=cmd_hedged_risk)

    sp = sub.add_parser("path-risk",
                        help="per-period path risk across model families "
                             "(terminal VaR/CVaR + max-drawdown distribution)")
    common(sp)
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: per-period option settlement")
    sp.add_argument("--models", default="gbm,student_t,garch,dcc,jump,heston,bootstrap",
                    help="comma list of gbm,student_t,garch,dcc,jump,heston,"
                         "bootstrap")
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--paths", type=int, default=65_536)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--p-restart", type=float, default=0.2,
                    help="bootstrap restart probability (1/expected block len)")
    sp.add_argument("--buy-and-hold", action="store_true",
                    help="buy-and-hold GBM wealth instead of the default "
                         "per-period rebalancing (GARCH/bootstrap always "
                         "rebalance — cross-family comparability)")
    sp.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="persist block-cursor state after every path block "
                         "(single --models entry only; resumed runs are "
                         "bit-identical to unsplit ones)")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint FILE")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws (degree-5 polynomial "
                         "Box-Muller, draw error <=~1.5e-4; gbm kernel path "
                         "only — student_t innovations and other families "
                         "have their own samplers and ignore it)")
    sp.add_argument("--ci", type=int, nargs="?", const=200, default=0,
                    metavar="B",
                    help="bootstrap error bars on the reported tail metrics "
                         "(B multinomial resamples of the sketch, default "
                         "200; pure post-processing, streams unchanged)")
    sp.add_argument("--no-pallas", action="store_true",
                    help="force the lax engine")
    sp.set_defaults(fn=cmd_path_risk)

    sp = sub.add_parser("sim-frontier", help="weight search against simulated GBM paths")
    common(sp)
    sp.add_argument("--candidates", type=int, default=100_000)
    sp.add_argument("--paths", type=int, default=16_384)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--objective", default="cvar", choices=["sharpe", "var", "cvar", "return"])
    sp.add_argument("--streaming", action="store_true",
                    help="constant-compile streaming engine (1M+ candidates)")
    sp.add_argument("--min-weight", type=float, default=0.0)
    sp.add_argument("--max-weight", type=float, default=1.0)
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: {asset: {strategy, params} | {legs}} — option legs settle against simulated prices (see mcport.options.hedged.legs_from_spec)")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_sim_frontier)

    sp = sub.add_parser("dd-frontier", help="max return s.t. a simulated max-drawdown budget")
    common(sp)
    sp.add_argument("--dd-budget", type=float, default=0.30,
                    help="p95-worst drawdown budget (0.30 = -30%%)")
    sp.add_argument("--candidates", type=int, default=8192)
    sp.add_argument("--paths", type=int, default=16_384)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--score-dtype",
                    choices=["auto", "float32", "tensorfloat32", "bfloat16"],
                    default="auto",
                    help="candidate-scoring matmul tier: auto (default) "
                         "bf16-screens + exact-rescores when provably "
                         "exact-at-the-optimum and worth the extra dispatch; "
                         "tensorfloat32 runs the scoring product on TF32 "
                         "tensor cores; bfloat16 screens with bf16 operands "
                         "then re-scores the leaders at f32")
    sp.add_argument("--rebalance", action="store_true",
                    help="rebalance candidates to target weights every period "
                         "(reference historical semantics) instead of buy-and-hold")
    sp.add_argument("--model",
                    choices=["gbm", "garch", "dcc", "jump", "heston",
                             "bootstrap"],
                    default="gbm",
                    help="path family: garch = volatility-clustered frontier, "
                         "dcc = dynamic-correlation frontier, jump = "
                         "systemic-crash (Merton) frontier, heston = "
                         "stochastic-volatility frontier, bootstrap = "
                         "distribution-free resampled frontier (all "
                         "per-period rebalanced; --score-dtype/--rebalance "
                         "apply to gbm only)")
    sp.add_argument("--innovations", choices=["normal", "student_t"],
                    default="normal",
                    help="gbm shock law: student_t scores candidates under "
                         "fat-tailed unit-variance t shocks (moment-fitted "
                         "dof; gbm model only)")
    sp.add_argument("--hedge", default=None, metavar="FILE",
                    help="JSON hedge config: {asset: {strategy, params} | {legs}} — option legs settle against simulated prices (see mcport.options.hedged.legs_from_spec)")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws for screen AND rescore "
                         "(stream-consistent; draw error <=~1.5e-4; gbm "
                         "kernel path only)")
    sp.add_argument("--no-pallas", action="store_true",
                    help="force the lax engine (gbm model)")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_dd_frontier)

    sp = sub.add_parser("backtest",
                        help="walk-forward out-of-sample comparison of "
                             "allocation rules")
    common(sp)
    sp.add_argument("--window", type=int, default=104,
                    help="lookback periods per fit (default 104 = 2y weekly)")
    sp.add_argument("--horizon", type=int, default=13,
                    help="periods held between rebalances")
    sp.add_argument("--rules", default=None,
                    help="comma list (default: all built-ins): equal,"
                         "inverse_vol,min_var,max_sharpe,min_cvar,min_cdar,"
                         "erc,hrp")
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--cost-bps", type=float, default=0.0,
                    help="proportional switching cost in basis points of "
                         "traded wealth (half-L1 of the weight change)")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_backtest)

    sp = sub.add_parser("bl-frontier",
                        help="Black-Litterman posterior (equilibrium + views) "
                             "fed into the exact mean-variance frontier")
    common(sp)
    sp.add_argument("--market-weights", default=None,
                    help="comma list (cap weights); default equal")
    sp.add_argument("--view", action="append", default=None,
                    metavar="ASSET=Q | LONG>SHORT=Q",
                    help="absolute ('btc=0.5') or relative ('btc>eth=0.1') "
                         "annualized view; repeatable; names match substrings")
    sp.add_argument("--tau", type=float, default=0.05)
    sp.add_argument("--delta", type=float, default=2.5,
                    help="market risk aversion for reverse optimization")
    sp.add_argument("--min-weight", type=float, default=0.0)
    sp.add_argument("--max-weight", type=float, default=1.0)
    sp.set_defaults(fn=cmd_bl_frontier)

    sp = sub.add_parser("stress",
                        help="scenario stress test: risk deltas under shocked "
                             "parameters (vol x1.5/x2, corr->1, -1sig means, "
                             "crash jump)")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--path-stats", action="store_true",
                    help="stress the max-drawdown DISTRIBUTION instead of "
                         "terminal risk (path engine per scenario; dd_p95 "
                         "deltas; crash via the Merton path engine)")
    sp.add_argument("--crash-rate", type=float, default=0.05,
                    help="systemic jump rate per step for the crash overlay")
    sp.add_argument("--crash-size", type=float, default=-0.10,
                    help="common mean log-jump size for the crash overlay")
    sp.add_argument("--no-crash", action="store_true",
                    help="skip the Merton crash-overlay scenario")
    _estimator_flags(sp)
    sp.set_defaults(fn=cmd_stress)

    sp = sub.add_parser("forecast", help="ARIMA+GARCH price forecasts")
    common(sp)
    sp.add_argument("--horizons", default="1,3,6")
    sp.set_defaults(fn=cmd_forecast)

    sp = sub.add_parser("serve", help="compile-once serve-many JSON API over "
                        "every command (mcport/serve.py)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8799)
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
