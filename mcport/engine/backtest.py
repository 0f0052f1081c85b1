"""Walk-forward out-of-sample backtesting of allocation rules.

The reference evaluates portfolios only in-sample (the tab-2 metrics are
computed on the same history the weights were searched on —
/root/reference/app.py:708-717). This engine adds the evaluation harness a
production framework needs: rolling re-estimation on a lookback window, held
out-of-sample for a rebalance horizon, with the realized OOS return series —
not the fitting window — scoring each rule.

Protocol: rebalance dates t_k = window + k*horizon. At each t_k a rule sees
ONLY returns[t_k - window : t_k] and emits weights w_k; the portfolio then
earns the reference's per-period-rebalanced convention r_t·w_k
(app.py:710) for the next `horizon` periods. Metrics over the concatenated
OOS series reuse the repo's risk library (ddof=1 Sharpe, cumprod max
drawdown, top-k VaR/CVaR conventions).

Built-in rules span the framework's allocator tiers: equal weight, inverse
volatility, exact min-variance and max-Sharpe (PGD QP, frontier_opt), exact
min-CVaR over the window scenarios (cvar_opt), exact min-CDaR over the
window path (cdar_opt), simulated drawdown-budget frontier over the next
horizon (dd_budget: drawdown_frontier — the multi-dd kernel on the GPU), ERC
risk parity and HRP (risk_parity). Custom rules are any
``f(window_returns) -> weights``.

JAX rules are jit-cached by window shape, so the rolling loop pays one
compile per rule; the loop itself is host-side on purpose — rebalance counts
are O(100), and rule heterogeneity (host HRP next to jitted PGD) matters
more than fusing a tiny loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = ["BacktestResult", "walk_forward", "BUILTIN_RULES", "make_rules",
           "probabilistic_sharpe"]


def _rule_equal(r: np.ndarray) -> np.ndarray:
    a = r.shape[1]
    return np.full(a, 1.0 / a)


def _window_cov(r: np.ndarray, estimator: str = "sample",
                ewma_lambda: float = 0.94) -> np.ndarray:
    """Window covariance under the selected estimator tier (the same tiers
    as ``estimate_gbm``): reference sample ddof=1 | Ledoit-Wolf shrinkage |
    RiskMetrics EWMA. Rolling fit windows are exactly where the sample
    estimator is weakest (short, wide), so the tier choice is OOS-testable
    here."""
    if estimator == "sample":
        return np.atleast_2d(np.cov(r, rowvar=False, ddof=1))
    if estimator == "lw":
        from mcport.models.gbm import ledoit_wolf_shrinkage

        return ledoit_wolf_shrinkage(r)[0]
    if estimator == "ewma":
        from mcport.models.gbm import ewma_cov

        return ewma_cov(r, ewma_lambda)
    raise ValueError(f"estimator must be 'sample', 'lw' or 'ewma', got {estimator!r}")


def _rule_inverse_vol(r: np.ndarray) -> np.ndarray:
    sd = r.std(axis=0, ddof=1)
    inv = 1.0 / np.maximum(sd, 1e-12)
    return inv / inv.sum()


def _rule_min_var(r: np.ndarray, estimator: str = "sample",
                  ewma_lambda: float = 0.94) -> np.ndarray:
    from mcport.engine.frontier_opt import exact_frontier, min_variance_exact

    a = r.shape[1]
    mean = r.mean(axis=0)
    cov = _window_cov(r, estimator, ewma_lambda)
    fr = exact_frontier(mean, cov, np.zeros(a), np.ones(a), n_lambda=2)
    return min_variance_exact(fr)[0]


def _rule_max_sharpe(r: np.ndarray, risk_free: float = 0.0,
                     ann_factor: int = 52, estimator: str = "sample",
                     ewma_lambda: float = 0.94) -> np.ndarray:
    from mcport.engine.frontier_opt import exact_frontier, max_sharpe_exact

    a = r.shape[1]
    mean = r.mean(axis=0) * ann_factor
    cov = _window_cov(r, estimator, ewma_lambda) * ann_factor
    fr = exact_frontier(mean, cov, np.zeros(a), np.ones(a), n_lambda=33,
                        risk_free=risk_free)
    return max_sharpe_exact(fr)[0]


def _rule_min_cvar(r: np.ndarray, alpha: float = 0.95) -> np.ndarray:
    from mcport.engine.cvar_opt import cvar_frontier, min_cvar_exact

    fr = cvar_frontier(r, alpha=alpha, n_lambda=2, n_stages=5, n_iter=150)
    return min_cvar_exact(fr)[0]


def _rule_min_cdar(r: np.ndarray, alpha: float = 0.95) -> np.ndarray:
    from mcport.engine.cdar_opt import cdar_frontier, min_cdar_exact

    fr = cdar_frontier(r, alpha=alpha, n_lambda=2, n_stages=5, n_iter=150)
    return min_cdar_exact(fr)[0]


def _rule_dd_budget(r: np.ndarray, dd_budget: float = 0.30,
                    alpha: float = 0.95, n_steps: int = 13,
                    n_candidates: int = 2048, n_paths: int = 2048,
                    estimator: str = "sample", ewma_lambda: float = 0.94,
                    ) -> np.ndarray:
    """Max simulated return s.t. a p95 max-drawdown budget over the NEXT
    horizon: fit per-step GBM moments to the window's log returns, run the
    drawdown-constrained frontier (engine.drawdown_frontier — the multi-dd
    kernel on the GPU, lax elsewhere), and hold the feasible-return argmax.
    Deterministic (fixed candidate/path key); equal weight when nothing
    satisfies the budget. Opt-in by name — NOT part of the ``rules=None``
    default set (a simulated frontier per rebalance date is orders of
    magnitude costlier than the closed-form rules)."""
    import jax

    from mcport.engine.drawdown_frontier import drawdown_frontier_search
    from mcport.models.gbm import GBMParams

    a = r.shape[1]
    lr = np.log1p(np.clip(np.asarray(r, np.float64), -0.9999, None))
    cov = _window_cov(lr, estimator, ewma_lambda)
    params = GBMParams(
        s0=np.ones(a), mean_step=lr.mean(axis=0),
        chol_step=np.linalg.cholesky(cov + 1e-10 * np.eye(a)))
    res = drawdown_frontier_search(
        jax.random.key(0), params, dd_budget=dd_budget,
        n_candidates=n_candidates, n_paths=n_paths, n_steps=n_steps,
        alpha=alpha, rebalance=True)
    if res.opt_idx < 0:
        return np.full(a, 1.0 / a)
    return np.asarray(res.opt_weights, np.float64)


def _rule_erc(r: np.ndarray, estimator: str = "sample",
              ewma_lambda: float = 0.94) -> np.ndarray:
    from mcport.engine.risk_parity import risk_parity

    cov = _window_cov(r, estimator, ewma_lambda)
    return risk_parity(cov)


def _rule_hrp(r: np.ndarray, estimator: str = "sample",
              ewma_lambda: float = 0.94) -> np.ndarray:
    from mcport.engine.risk_parity import hierarchical_risk_parity

    cov = _window_cov(r, estimator, ewma_lambda)
    return hierarchical_risk_parity(cov)


BUILTIN_RULES: Mapping[str, Callable[[np.ndarray], np.ndarray]] = {
    "equal": _rule_equal,
    "inverse_vol": _rule_inverse_vol,
    "min_var": _rule_min_var,
    "max_sharpe": _rule_max_sharpe,
    "min_cvar": _rule_min_cvar,
    "min_cdar": _rule_min_cdar,
    "dd_budget": _rule_dd_budget,
    "erc": _rule_erc,
    "hrp": _rule_hrp,
}


def make_rules(names: Sequence[str], risk_free: float = 0.0,
               ann_factor: int = 52, alpha: float = 0.95,
               dd_budget: float = 0.30, horizon: int = 13,
               estimator: str = "sample", ewma_lambda: float = 0.94,
               ) -> dict[str, Callable[[np.ndarray], np.ndarray]]:
    """Resolve rule names to callables, binding shared parameters
    (``estimator`` selects the window-covariance tier for every
    covariance-consuming rule — sample | lw | ewma)."""
    out: dict[str, Callable[[np.ndarray], np.ndarray]] = {}
    est, lam = estimator, ewma_lambda
    for name in names:
        if name == "max_sharpe":
            out[name] = lambda r, rf=risk_free, af=ann_factor: (
                _rule_max_sharpe(r, rf, af, est, lam))
        elif name == "min_var":
            out[name] = lambda r: _rule_min_var(r, est, lam)
        elif name == "erc":
            out[name] = lambda r: _rule_erc(r, est, lam)
        elif name == "hrp":
            out[name] = lambda r: _rule_hrp(r, est, lam)
        elif name == "min_cvar":
            out[name] = lambda r, al=alpha: _rule_min_cvar(r, al)
        elif name == "min_cdar":
            out[name] = lambda r, al=alpha: _rule_min_cdar(r, al)
        elif name == "dd_budget":
            out[name] = lambda r, b=dd_budget, al=alpha, h=horizon: (
                _rule_dd_budget(r, b, al, h, estimator=est, ewma_lambda=lam))
        elif name in BUILTIN_RULES:
            out[name] = BUILTIN_RULES[name]
        else:
            raise ValueError(
                f"unknown rule {name!r}; available: {sorted(BUILTIN_RULES)}")
    return out


@dataclass(frozen=True)
class BacktestResult:
    rule_names: tuple[str, ...]
    rebal_idx: np.ndarray        # (K,) rebalance period indices into returns
    weights: np.ndarray          # (R, K, A) weights chosen at each rebalance
    oos_returns: np.ndarray      # (R, T_oos) realized per-period OOS returns
    summary: dict[str, dict[str, float]]   # per rule: the OOS scorecard

    def oos_curve(self, rule: str) -> np.ndarray:
        """Compounded OOS wealth curve (T_oos,) for one rule, V_0 = 1."""
        i = self.rule_names.index(rule)
        return np.cumprod(1.0 + self.oos_returns[i])


def probabilistic_sharpe(oos: np.ndarray, sr_benchmark: float = 0.0) -> float:
    """Bailey & Lopez de Prado's PSR: P[true per-period Sharpe > benchmark]
    given the observed series' length, skewness, and kurtosis —

        PSR = Phi( (SR - SR*) sqrt(T - 1) / sqrt(1 - g3 SR + (g4-1)/4 SR^2) )

    with SR the PER-PERIOD observed Sharpe (ddof=1), g3 skewness, g4
    (non-excess) kurtosis. Guards a backtest against noise-mined Sharpe:
    short fat-tailed series earn low PSR even at high point estimates.
    """
    from scipy.stats import norm

    r = np.asarray(oos, np.float64)
    t = r.shape[0]
    sd = r.std(ddof=1)
    if t < 4 or sd == 0:
        return float("nan")
    sr = r.mean() / sd
    z = (r - r.mean()) / sd
    g3 = float(np.mean(z**3))
    g4 = float(np.mean(z**4))
    denom = 1.0 - g3 * sr + (g4 - 1.0) / 4.0 * sr * sr
    if denom <= 0:
        return float("nan")
    return float(norm.cdf((sr - sr_benchmark) * np.sqrt(t - 1) / np.sqrt(denom)))


def _score(oos: np.ndarray, risk_free: float, ann_factor: int,
           alpha: float, weights: np.ndarray) -> dict[str, float]:
    import jax.numpy as jnp

    from mcport.stats.risk import cvar, max_drawdown, sharpe_ratio, var

    r = jnp.asarray(oos, jnp.float32)
    # half-L1 = traded fraction of wealth, the SAME unit cost_bps charges
    turnover = float(0.5 * np.abs(np.diff(weights, axis=0)).sum(axis=1).mean()) \
        if weights.shape[0] > 1 else 0.0
    return {
        "total_return": float(np.prod(1.0 + oos) - 1.0),
        "ann_return": float(oos.mean() * ann_factor),
        "ann_vol": float(oos.std(ddof=1) * np.sqrt(ann_factor)),
        "sharpe": float(sharpe_ratio(r, risk_free, ann_factor)),
        "prob_sharpe": probabilistic_sharpe(oos),
        "max_drawdown": float(max_drawdown(r)),
        "var": float(var(r, alpha)),
        "cvar": float(cvar(r, alpha)),
        "avg_turnover": turnover,
    }


def walk_forward(
    returns: np.ndarray,
    window: int,
    horizon: int,
    rules: Mapping[str, Callable[[np.ndarray], np.ndarray]] | Sequence[str] | None = None,
    risk_free: float = 0.0,
    ann_factor: int = 52,
    alpha: float = 0.95,
    cost_bps: float = 0.0,
    estimator: str = "sample",
    ewma_lambda: float = 0.94,
) -> BacktestResult:
    """Walk-forward OOS backtest over a (T, A) per-period return matrix.

    ``rules`` may be a name list (resolved via :func:`make_rules`), a mapping
    of custom callables, or None for the full built-in set. Weights are
    renormalized defensively (a rule returning an off-simplex vector is a
    bug surfaced by the assert, not silently traded).

    ``cost_bps`` charges proportional switching costs: at each rebalance
    after the first, the period's return is reduced by
    ``cost_bps/1e4 * 0.5 * ||w_k - w_{k-1}||_1`` (half-L1 = traded fraction
    of wealth). This prices only target SWITCHES — the per-period drift
    correction implied by the rebalanced R·w convention is not charged, so
    cost ordering between rules (high- vs low-turnover) is honest while
    absolute levels are a lower bound."""
    r = np.asarray(returns, np.float64)
    if r.ndim != 2:
        raise ValueError(f"returns must be (T, A); got {r.shape}")
    t_len, a = r.shape
    if window < 4 or horizon < 1:
        raise ValueError("need window >= 4 and horizon >= 1")
    if t_len < window + horizon:
        raise ValueError(
            f"need at least window+horizon={window + horizon} periods, got {t_len}")
    if rules is None:
        # dd_budget is opt-in: a simulated frontier per rebalance date costs
        # orders of magnitude more than the closed-form default rules
        default = tuple(n for n in BUILTIN_RULES if n != "dd_budget")
        rules = make_rules(default, risk_free, ann_factor, alpha,
                           horizon=horizon, estimator=estimator,
                           ewma_lambda=ewma_lambda)
    elif not isinstance(rules, Mapping):
        rules = make_rules(tuple(rules), risk_free, ann_factor, alpha,
                           horizon=horizon, estimator=estimator,
                           ewma_lambda=ewma_lambda)

    rebal = np.arange(window, t_len - horizon + 1, horizon)
    names = tuple(rules)
    n_rules, n_rebal = len(names), len(rebal)
    weights = np.zeros((n_rules, n_rebal, a))
    oos = np.zeros((n_rules, n_rebal * horizon))

    for k, t0 in enumerate(rebal):
        fit = r[t0 - window:t0]
        hold = r[t0:t0 + horizon]
        for i, name in enumerate(names):
            w = np.asarray(rules[name](fit), np.float64).reshape(-1)
            if (w.shape != (a,) or not np.isfinite(w).all()
                    or (w < -1e-9).any() or w.sum() <= 0):
                raise ValueError(f"rule {name!r} returned invalid weights {w}")
            w = np.clip(w, 0.0, None)     # float-drift only; negatives raised above
            w = w / w.sum()
            weights[i, k] = w
            oos[i, k * horizon:(k + 1) * horizon] = hold @ w
            if cost_bps > 0.0 and k > 0:
                traded = 0.5 * np.abs(w - weights[i, k - 1]).sum()
                oos[i, k * horizon] -= cost_bps / 1e4 * traded

    summary = {
        name: _score(oos[i], risk_free, ann_factor, alpha, weights[i])
        for i, name in enumerate(names)
    }
    return BacktestResult(rule_names=names, rebal_idx=rebal, weights=weights,
                          oos_returns=oos, summary=summary)
