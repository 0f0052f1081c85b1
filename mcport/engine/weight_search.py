"""Batched random-weight portfolio search — the reference's core capability
(tab 2, app.py:669-723) rebuilt as one XLA program per method.

Reference semantics preserved:

- per-method fresh sampling: each of the 4 sampled methods draws its own 2,500
  Dirichlet candidates (app.py:682,699) — here each method gets a split key;
- per-candidate metrics (app.py:708-717): return ``w·mu``, std ``sqrt(w'Σw)``,
  historical series ``R·w``, Sharpe ``(ret - rf)/std`` (annual rf, NOT de-annualized
  — this tab's Sharpe differs from ``sharpe_ratio``'s, app.py:691 vs 232),
  historical VaR95/CVaR95 of the series;
- stored-metric convention: VaR/CVaR metrics are stored negated and the optimum is
  their argmin (app.py:697,673-674) — net effect "minimize tail loss" — we keep the
  stored form so plots/colors match;
- Equal Weight violating the bounds appends nothing, which crashes the reference
  with an IndexError on argmax of empty (SURVEY.md §2); here it returns
  ``n_valid == 0`` with ``opt_idx == -1`` instead.

New beyond the reference: the ``target_risk`` objective (the README's "30%
target-risk portfolio", reference README.md:4 — dropped from the app but mandated
by BASELINE.json:9): maximize expected return among candidates with
``std <= target``; if none qualify, take the candidate closest to the target risk.

Device mapping: candidate weights (N, A) evaluate against the return history via a
single (N, A) x (A, T) matmul, chunked by ``cand_block`` via ``lax.map``
so N can reach millions without materializing the (N, T) series matrix in HBM at
once. VaR quantiles sort inside each chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.ops.dirichlet import (
    _sample_unconstrained,
    constraint_mask,
    sample_constrained_weights,
    sample_weights,
)
from mcport.stats.risk import cvar as hist_cvar
from mcport.stats.risk import var as hist_var

__all__ = [
    "PortfolioEval",
    "MethodResult",
    "METHODS",
    "evaluate_portfolios",
    "run_method",
    "run_all_methods",
    "cal_line",
    "efficient_frontier",
]

# Reference method table (app.py:671-677): name -> (stored-metric kind, colorscale).
# 'Monte Carlo' and 'MPT' are numerically identical (SURVEY.md §2); MPT only adds
# the CAL overlay at plot time. 'target_risk' is the mcport addition.
METHODS: dict[str, dict] = {
    "Monte Carlo": {"metric": "sharpe", "color": "Viridis"},
    "VaR": {"metric": "var_95", "color": "Plasma"},
    "CVaR": {"metric": "cvar_95", "color": "Inferno"},
    "MPT": {"metric": "sharpe", "color": "Viridis"},
    "Equal Weight": {"metric": "sharpe", "color": "Blues"},
    "Target Risk": {"metric": "target_risk", "color": "Cividis"},
}


class PortfolioEval(NamedTuple):
    """Per-candidate portfolio metrics (app.py:708-717)."""

    ret: Array      # (N,) annualized expected return w·mu
    std: Array      # (N,) annualized volatility sqrt(w'Σw)
    sharpe: Array   # (N,) (ret - rf)/std, 0 where std == 0
    var_95: Array   # (N,) historical VaR of the series R·w
    cvar_95: Array  # (N,) historical CVaR


@partial(jax.jit, static_argnames=("alpha", "cand_block"))
def evaluate_portfolios(
    weights: Array,
    returns: Array,
    mean_ann: Array,
    cov_ann: Array,
    risk_free: float = 0.0,
    alpha: float = 0.95,
    cand_block: int = 8192,
) -> PortfolioEval:
    """Evaluate (N, A) candidate weights against (T, A) historical returns.

    Chunked over candidates: each chunk does an (B, A) x (A, T) matmul for the
    historical series, then per-row quantile/tail-mean for VaR/CVaR.
    """
    weights = jnp.asarray(weights)
    returns = jnp.asarray(returns, weights.dtype)
    mean_ann = jnp.asarray(mean_ann, weights.dtype)
    cov_ann = jnp.asarray(cov_ann, weights.dtype)
    n, a = weights.shape

    ret = weights @ mean_ann                                   # (N,)
    quad = jnp.einsum("na,ab,nb->n", weights, cov_ann, weights)
    std = jnp.sqrt(jnp.maximum(quad, 0.0))
    sharpe = jnp.where(std > 0, (ret - risk_free) / jnp.where(std > 0, std, 1.0), 0.0)

    # chunked historical-series tail stats
    block = min(cand_block, n)
    n_pad = -(-n // block) * block
    w_pad = jnp.pad(weights, ((0, n_pad - n), (0, 0)))
    rt = returns.T                                             # (A, T)

    def chunk_stats(w_blk: Array) -> tuple[Array, Array]:
        series = w_blk @ rt                                    # (B, T) matmul
        v = hist_var(series, alpha)
        c = hist_cvar(series, alpha)
        return v, c

    v, c = jax.lax.map(chunk_stats, w_pad.reshape(-1, block, a))
    var_95 = v.reshape(-1)[:n]
    cvar_95 = c.reshape(-1)[:n]
    return PortfolioEval(ret, std, sharpe, var_95, cvar_95)


@dataclass(frozen=True)
class MethodResult:
    """One simulation method's candidate cloud + optimum."""

    method: str
    weights: np.ndarray        # (N, A)
    ret: np.ndarray            # (N,)
    std: np.ndarray            # (N,)
    metric: np.ndarray         # (N,) stored-form metric (sharpe, -var, -cvar, or ret)
    valid: np.ndarray          # (N,) bool — constraint-respecting candidates
    opt_idx: int               # -1 when no valid candidate exists
    eval: PortfolioEval

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def opt_weights(self) -> np.ndarray | None:
        return None if self.opt_idx < 0 else self.weights[self.opt_idx]

    def allocations(self, investment: float) -> np.ndarray | None:
        """Dollar allocation of the optimal portfolio (app.py:764)."""
        w = self.opt_weights
        return None if w is None else w * investment


def _stored_metric(kind: str, ev: PortfolioEval) -> Array:
    if kind == "sharpe":
        return ev.sharpe
    if kind == "var_95":
        return -ev.var_95     # stored negated (app.py:697)
    if kind == "cvar_95":
        return -ev.cvar_95
    if kind == "target_risk":
        return ev.ret
    raise ValueError(f"unknown metric kind {kind!r}")


def _select_optimum(kind: str, metric: Array, ev: PortfolioEval, valid: Array,
                    target_risk: float) -> Array:
    neg_inf = jnp.asarray(-jnp.inf, metric.dtype)
    if kind == "sharpe":
        return jnp.argmax(jnp.where(valid, metric, neg_inf))
    if kind in ("var_95", "cvar_95"):
        # argmin of the stored (negated) metric == smallest tail loss (app.py:673-674)
        return jnp.argmin(jnp.where(valid, metric, jnp.inf))
    if kind == "target_risk":
        feasible = valid & (ev.std <= target_risk)
        best_ret = jnp.argmax(jnp.where(feasible, ev.ret, neg_inf))
        nearest = jnp.argmin(jnp.where(valid, jnp.abs(ev.std - target_risk), jnp.inf))
        return jnp.where(jnp.any(feasible), best_ret, nearest)
    raise ValueError(f"unknown metric kind {kind!r}")


def run_method(
    key: Array,
    method: str,
    returns: Array,
    mean_ann: Array,
    cov_ann: Array,
    risk_free: float = 0.0,
    n_portfolios: int = 2500,
    min_weights: Array | None = None,
    max_weights: Array | None = None,
    max_retries: int = 100,
    alpha: float = 0.95,
    target_risk: float = 0.30,
    cand_block: int = 8192,
    dtype=jnp.float32,
) -> MethodResult:
    """Run one simulation method end to end (sampling → metrics → optimum)."""
    cfg = METHODS[method]
    a = np.shape(mean_ann)[-1]
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)

    if method == "Equal Weight":
        w = jnp.full((1, a), 1.0 / a, dtype)
        valid = constraint_mask(w, min_w, max_w)
    else:
        w, valid = sample_weights(key, n_portfolios, min_w, max_w, max_retries)
        w = w.astype(dtype)

    ev = evaluate_portfolios(w, jnp.asarray(returns, dtype), mean_ann, cov_ann,
                             risk_free, alpha, cand_block)
    metric = _stored_metric(cfg["metric"], ev)
    any_valid = bool(jnp.any(valid))
    opt_idx = (
        int(_select_optimum(cfg["metric"], metric, ev, valid, target_risk))
        if any_valid
        else -1  # Equal-Weight-violates-bounds guard (reference IndexError)
    )
    return MethodResult(
        method=method,
        weights=np.asarray(w),
        ret=np.asarray(ev.ret),
        std=np.asarray(ev.std),
        metric=np.asarray(metric),
        valid=np.asarray(valid),
        opt_idx=opt_idx,
        eval=ev,
    )


@partial(
    jax.jit,
    static_argnames=("kinds", "n_portfolios", "max_retries", "alpha",
                     "cand_block", "trivial", "dtype"),
)
def _fused_methods(
    keys, returns, mean_ann, cov_ann, min_w, max_w, risk_free, target_risk,
    kinds: tuple[str, ...], n_portfolios: int, max_retries: int, alpha: float,
    cand_block: int, trivial: bool, dtype=jnp.float32,
):
    """All sampled methods in ONE compiled dispatch (VERDICT r2 item 7).

    The reference workload is interactive — 2,500 candidates x 4 sampled
    methods per rerun (app.py:681-682) — where per-method dispatch/transfer
    round-trips dominate compute. This folds
    sampling (vmapped over the same per-method keys the sequential path
    uses), one stacked (M*N, A) evaluation, stored metrics, and on-device
    optimum selection into a single program with a single host fetch.
    Per-candidate results are bit-identical to the sequential
    :func:`run_method` path (pinned in tests): vmapped key-addressed draws
    equal their sequential draws, and every evaluation op is row-wise.
    """
    m = len(kinds)
    a = mean_ann.shape[-1]

    if trivial:
        def samp(k):
            _, sub = jax.random.split(k)
            return _sample_unconstrained(sub, n_portfolios, a)
    else:
        def samp(k):
            return sample_constrained_weights(k, n_portfolios, min_w, max_w,
                                              max_retries)

    w, valid = jax.vmap(samp)(keys)                     # (M, N, A), (M, N)
    w = w.astype(dtype)
    ev = evaluate_portfolios(
        w.reshape(m * n_portfolios, a), returns, mean_ann, cov_ann,
        risk_free, alpha, cand_block,
    )
    ev_m = PortfolioEval(*(f.reshape(m, n_portfolios) for f in ev))

    metrics, opts, any_valid = [], [], []
    for i, kind in enumerate(kinds):
        ev_i = PortfolioEval(*(f[i] for f in ev_m))
        metric = _stored_metric(kind, ev_i)
        metrics.append(metric)
        opts.append(_select_optimum(kind, metric, ev_i, valid[i], target_risk))
        any_valid.append(jnp.any(valid[i]))
    return (w, valid, ev_m, jnp.stack(metrics), jnp.stack(opts),
            jnp.stack(any_valid))


def run_all_methods(
    key: Array,
    returns: Array,
    mean_ann: Array,
    cov_ann: Array,
    methods: tuple[str, ...] = ("Monte Carlo", "VaR", "CVaR", "MPT", "Equal Weight"),
    risk_free: float = 0.0,
    n_portfolios: int = 2500,
    min_weights: Array | None = None,
    max_weights: Array | None = None,
    max_retries: int = 100,
    alpha: float = 0.95,
    target_risk: float = 0.30,
    cand_block: int = 8192,
    dtype=jnp.float32,
) -> dict[str, MethodResult]:
    """All simulation methods, each with its own sampling key (app.py:682 loop).

    Default method tuple matches the reference's five; add "Target Risk" for the
    BASELINE.json target-risk objective. The sampled methods run as ONE fused
    device dispatch with a single host fetch (:func:`_fused_methods` — the
    interactive-latency path); Equal Weight (1 deterministic candidate) runs
    separately. Results are bit-identical to calling :func:`run_method` per
    method with the same split keys.
    """
    keys = jax.random.split(key, len(methods))
    out: dict[str, MethodResult] = {}

    sampled = [(m, k) for m, k in zip(methods, keys) if m != "Equal Weight"]
    a = np.shape(mean_ann)[-1]
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)

    if sampled:
        trivial = bool((np.asarray(min_w) <= 0).all()
                       and (np.asarray(max_w) >= 1).all())
        kinds = tuple(METHODS[m]["metric"] for m, _ in sampled)
        w, valid, ev_m, metrics, opt_idx, any_valid = jax.device_get(
            _fused_methods(
                jnp.stack([k for _, k in sampled]),
                jnp.asarray(returns, dtype), jnp.asarray(mean_ann),
                jnp.asarray(cov_ann), min_w, max_w, risk_free, target_risk,
                kinds, n_portfolios, max_retries, alpha, cand_block, trivial,
                dtype,
            ))
        for i, (m, _) in enumerate(sampled):
            ev_i = PortfolioEval(*(np.asarray(f[i]) for f in ev_m))
            out[m] = MethodResult(
                method=m,
                weights=np.asarray(w[i]),
                ret=ev_i.ret, std=ev_i.std,
                metric=np.asarray(metrics[i]),
                valid=np.asarray(valid[i]),
                opt_idx=int(opt_idx[i]) if bool(any_valid[i]) else -1,
                eval=ev_i,
            )

    for m, k in zip(methods, keys):
        if m == "Equal Weight":
            out[m] = run_method(
                k, m, returns, mean_ann, cov_ann, risk_free=risk_free,
                n_portfolios=n_portfolios, min_weights=min_weights,
                max_weights=max_weights, max_retries=max_retries, alpha=alpha,
                target_risk=target_risk, cand_block=cand_block, dtype=dtype,
            )
    # preserve caller's method order
    return {m: out[m] for m in methods}


def efficient_frontier(
    mean_returns,
    cov_matrix,
    points: int = 200,
    min_weights=None,
    max_weights=None,
    seed: int = 0,
):
    """Random-portfolio frontier cloud — API parity with the reference's
    ``efficient_frontier`` (app.py:265-284; defined but never called there).

    Returns ``(results (3, points), weight_record (points, A))`` with rows
    (std, return, return/std) like the original. Differences (documented):
    the original's 100-retry loop falls through *using the last draw even when
    invalid* (SURVEY.md §2); here rows that never satisfied the bounds are
    returned with NaN metrics instead of silently-invalid weights.
    """
    mean_returns = jnp.asarray(mean_returns)
    cov_matrix = jnp.asarray(cov_matrix)
    a = mean_returns.shape[-1]
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)
    w, valid = sample_weights(jax.random.key(seed), points, min_w, max_w)
    w = w.astype(mean_returns.dtype)
    ret = w @ mean_returns
    std = jnp.sqrt(jnp.maximum(jnp.einsum("na,ab,nb->n", w, cov_matrix, w), 0.0))
    ratio = jnp.where(std > 0, ret / jnp.where(std > 0, std, 1.0), 0.0)
    nan = jnp.asarray(jnp.nan, ret.dtype)
    results = jnp.stack([
        jnp.where(valid, std, nan),
        jnp.where(valid, ret, nan),
        jnp.where(valid, ratio, nan),
    ])
    return np.asarray(results), np.asarray(w)


def cal_line(risk_free: float, sharpe_star: float, max_risk: float, n: int = 100):
    """Capital Allocation Line points for the MPT plot (app.py:740-742), in the
    reference's x100-percent plot units."""
    x = np.linspace(0.0, max_risk, n)
    return x, risk_free * 100 + sharpe_star * x
