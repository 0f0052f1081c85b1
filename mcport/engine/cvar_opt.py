"""Exact scenario-CVaR portfolio optimization (Rockafellar-Uryasev).

The reference estimates CVaR of a *given* portfolio (app.py:258-263) and finds
good portfolios only by random search over 2,500 Dirichlet draws
(app.py:699-717). mcport already scales that search to millions of candidates
(weight_search, simulated_frontier); this module adds the *exact* convex
counterpart for the tail objective, the way frontier_opt does for
mean-variance: the scenario program

    min_{w in S, a in R}  a + 1/((1-beta) N) sum_i max(-r_i.w - a, 0) - lam mu.w
    S = {w : sum w = 1, lo <= w <= hi}

whose (w, a) optimum has a* = the beta-VaR of losses and objective value
CVaR_beta (Rockafellar & Uryasev 2000). A lam sweep traces the mean-CVaR
frontier exactly, the tail analogue of the mean-variance frontier.

Device mapping: the non-smooth hinge is annealed through a softplus temperature
schedule and each stage solved by Nesterov projected gradient with a step from
a power-iterated curvature bound — fixed iteration counts, no data-dependent
control flow, and the whole lam sweep is ONE vmapped program whose per-iterate
cost is an (N, A) x (A, L) matmul. The reported metrics are re-evaluated
EXACTLY (lax.top_k tail means, same convention as simulated_frontier) so the
smoothing only steers the search, never the answer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.engine.frontier_opt import project_capped_simplex

__all__ = [
    "CVaRFrontier",
    "cvar_frontier",
    "min_cvar_exact",
    "max_return_at_cvar",
    "simulated_cvar_frontier",
    "exact_tail_metrics",
]


def exact_tail_metrics(scenarios: Array, w: Array, alpha: float) -> tuple[Array, Array]:
    """(var, cvar) in the repo's return convention (k-worst order statistic and
    k-worst mean of portfolio returns; both usually negative).

    ``scenarios`` is (N, A) simple returns, ``w`` is (..., A); k = ceil((1-alpha)N)
    matches simulated_frontier's tail convention.
    """
    port = scenarios @ jnp.swapaxes(jnp.atleast_2d(w), -1, -2)   # (N, ...)
    k_tail = max(1, math.ceil((1.0 - alpha) * scenarios.shape[0]))
    worst, _ = jax.lax.top_k(-jnp.swapaxes(port, -1, -2), k_tail)  # (..., k) losses
    var = -worst[..., -1]
    cvar = -worst.mean(axis=-1)
    if jnp.ndim(w) == 1:
        var, cvar = var[0], cvar[0]
    return var, cvar


def _curvature_bound(scenarios: Array, n_iter: int = 48) -> Array:
    """lammax of G = [R, 1]^T [R, 1] via power iteration (matvecs through R,
    never materializing G beyond (A+1,)); bounds the softplus Hessian."""
    n, a = scenarios.shape
    v = jnp.ones((a + 1,), scenarios.dtype) / jnp.sqrt(jnp.asarray(a + 1, scenarios.dtype))

    def mv(v):
        t = scenarios @ v[:a] + v[a]          # (N,)
        return jnp.concatenate([scenarios.T @ t, jnp.sum(t)[None]])

    def body(_, v):
        w = mv(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v)
    return v @ mv(v)


def anneal_ru_sweep(
    loss_of,                 # (A,)-weights -> (N,) loss series (convex in w)
    mu: Array,               # (A,) expected returns
    lams: Array,             # (L,) return-seeking sweep; 0 = pure min-risk
    lo: Array,
    hi: Array,
    alpha: float,
    n_scen: int,
    gmax: Array,             # curvature bound on the smoothed Hessian scale
    scale: Array,            # loss scale anchoring the temperature schedule
    n_stages: int,
    n_iter: int,
) -> Array:
    """Generic annealed smoothed Rockafellar-Uryasev solver -> (L, A).

    Shared by the mean-CVaR (loss = portfolio loss per scenario) and
    mean-CDaR (loss = drawdown per period, engine.cdar_opt) frontiers —
    step-size, clipping, and anneal-schedule fixes live HERE once. The
    non-smooth hinge is annealed through a softplus temperature schedule;
    each stage runs Nesterov projected gradient with a curvature-bounded
    step, then re-anchors the auxiliary variable at the exact loss-quantile.
    """
    a = mu.shape[-1]
    tail_frac = max(1.0 - alpha, 1.0 / n_scen)
    taus = scale * jnp.geomspace(1.0, 1e-4, n_stages).astype(mu.dtype)

    def solve(lam):
        w0 = project_capped_simplex(jnp.full_like(mu, 1.0 / a), lo, hi)
        a0 = jnp.quantile(loss_of(w0), alpha)     # exact loss-quantile at w0

        def objective(wa, tau):
            w, av = wa[:a], wa[a]
            losses = loss_of(w)
            z = (losses - av) / tau
            soft = tau * jnp.log1p(jnp.exp(jnp.clip(z, -30.0, 30.0)))
            # clip keeps exp finite; beyond +30 softplus(z) ~= z exactly in f32
            soft = jnp.where(z > 30.0, losses - av, soft)
            return av + soft.sum() / (tail_frac * n_scen) - lam * (mu @ w)

        grad = jax.grad(objective)

        def stage(carry, tau):
            wa = carry
            step = (4.0 * tau * tail_frac * n_scen) / jnp.maximum(gmax, 1e-30)

            def body(k, st):
                wa, z = st
                g = grad(z, tau)
                w_new = project_capped_simplex(z[:a] - step * g[:a], lo, hi)
                a_new = z[a] - step * g[a]
                wa_new = jnp.concatenate([w_new, a_new[None]])
                beta = (k / (k + 3.0)).astype(wa_new.dtype)
                z_new = wa_new + beta * (wa_new - wa)
                return wa_new, z_new

            wa, _ = jax.lax.fori_loop(0, n_iter, body, (wa, wa))
            # re-anchor a at the exact loss-quantile of the current w
            av = jnp.quantile(loss_of(wa[:a]), alpha)
            wa = wa.at[a].set(av)
            return wa, None

        wa0 = jnp.concatenate([w0, a0[None]])
        wa, _ = jax.lax.scan(stage, wa0, taus)
        return wa[:a]

    return jax.vmap(solve)(lams)


@partial(jax.jit, static_argnames=("alpha", "n_stages", "n_iter"))
def _solve_cvar_sweep(
    scenarios: Array,        # (N, A) simple returns
    mu: Array,               # (A,) expected returns (scenario mean by default)
    lams: Array,             # (L,) return-seeking sweep; 0 = pure min-CVaR
    lo: Array,
    hi: Array,
    alpha: float,
    n_stages: int = 6,
    n_iter: int = 200,
) -> Array:
    """Annealed smoothed Rockafellar-Uryasev, vmapped over lams -> (L, A)."""
    n, _ = scenarios.shape
    return anneal_ru_sweep(
        lambda w: -(scenarios @ w), mu, lams, lo, hi, alpha, n,
        _curvature_bound(scenarios), jnp.maximum(jnp.std(scenarios), 1e-8),
        n_stages, n_iter,
    )


@dataclass(frozen=True)
class CVaRFrontier:
    """Swept box-constrained mean-CVaR frontier over a scenario set."""

    lams: np.ndarray       # (L,) return-seeking sweep
    weights: np.ndarray    # (L, A)
    ret: np.ndarray        # (L,) mean scenario return mu'w
    std: np.ndarray        # (L,) scenario std of portfolio return (ddof=1)
    var: np.ndarray        # (L,) exact k-th-worst return (repo convention)
    cvar: np.ndarray       # (L,) exact k-worst mean return (repo convention)
    alpha: float

    def _pick(self, idx: int) -> tuple[np.ndarray, float, float]:
        return self.weights[idx], float(self.ret[idx]), float(self.cvar[idx])


def cvar_frontier(
    scenarios: np.ndarray,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    alpha: float = 0.95,
    mean_returns: np.ndarray | None = None,
    n_lambda: int = 33,
    lam_max: float | None = None,
    n_stages: int = 6,
    n_iter: int = 200,
    dtype=jnp.float32,
) -> CVaRFrontier:
    """Trace the exact mean-CVaR frontier over an (N, A) scenario-return set.

    Scenarios can be simulated terminals (see :func:`simulated_cvar_frontier`)
    or a historical return matrix — the program is the same. lam=0 is the
    global minimum-CVaR portfolio; ``lam_max`` defaults to a scale-aware value
    that reaches the return-dominated corner. All reported var/cvar columns are
    exact top-k evaluations of the final weights.
    """
    r = np.asarray(scenarios, np.float64)
    if r.ndim != 2:
        raise ValueError(f"scenarios must be (N, A); got shape {r.shape}")
    a = r.shape[1]
    lo = np.zeros(a) if min_weights is None else np.asarray(min_weights, np.float64)
    hi = np.ones(a) if max_weights is None else np.asarray(max_weights, np.float64)
    if lo.sum() > 1.0 + 1e-9 or hi.sum() < 1.0 - 1e-9:
        raise ValueError("infeasible weight bounds: need sum(min) <= 1 <= sum(max)")
    mu = r.mean(axis=0) if mean_returns is None else np.asarray(mean_returns, np.float64)
    if lam_max is None:
        # scale-aware (same pattern as frontier_opt): sweep far enough that
        # the return term lam*mu'w dominates the CVaR subgradient, whose
        # magnitude lives on the scenario loss scale.
        lam_max = 100.0 * max(float(r.std()), 1e-12) / max(float(np.abs(mu).max()), 1e-12)
    lams = np.concatenate([[0.0], np.geomspace(lam_max / 1e4, lam_max, n_lambda - 1)])

    w = np.asarray(
        _solve_cvar_sweep(
            jnp.asarray(r, dtype), jnp.asarray(mu, dtype), jnp.asarray(lams, dtype),
            jnp.asarray(lo, dtype), jnp.asarray(hi, dtype), float(alpha),
            n_stages, n_iter,
        ),
        np.float64,
    )
    port = r @ w.T                                   # (N, L)
    ret = w @ mu
    std = port.std(axis=0, ddof=1)
    var_e, cvar_e = exact_tail_metrics(jnp.asarray(r), jnp.asarray(w), float(alpha))
    return CVaRFrontier(
        lams=lams, weights=w, ret=ret, std=std,
        var=np.asarray(var_e, np.float64), cvar=np.asarray(cvar_e, np.float64),
        alpha=float(alpha),
    )


def min_cvar_exact(frontier: CVaRFrontier) -> tuple[np.ndarray, float, float]:
    """(weights, ret, cvar) of the global minimum-CVaR portfolio (max cvar in
    the repo's return convention = smallest tail loss)."""
    return frontier._pick(int(np.argmax(frontier.cvar)))


def max_return_at_cvar(
    frontier: CVaRFrontier, budget: float
) -> tuple[np.ndarray, float, float]:
    """Max mean return among frontier points whose tail loss respects
    ``budget`` (cvar >= budget, return convention: budget like -0.25);
    nearest-cvar fallback when nothing is feasible (target-risk semantics of
    weight_search)."""
    feasible = frontier.cvar >= budget
    if feasible.any():
        idx = int(np.argmax(np.where(feasible, frontier.ret, -np.inf)))
    else:
        idx = int(np.argmin(np.abs(frontier.cvar - budget)))
    return frontier._pick(idx)


def simulated_cvar_frontier(
    key: Array,
    params,
    n_paths: int = 16_384,
    n_steps: int = 252,
    alpha: float = 0.95,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    dtype=jnp.float32,
    **kwargs,
) -> CVaRFrontier:
    """Mean-CVaR frontier over simulated GBM terminal returns — the exact
    counterpart of simulated_weight_search(objective="cvar"), sharing its
    terminal-return scenario construction (same draw law, same tail
    convention)."""
    from mcport.models.gbm import terminal_log_returns

    term = terminal_log_returns(
        key, jnp.asarray(params.mean_step, dtype), jnp.asarray(params.chol_step, dtype),
        n_paths, n_steps, dtype=dtype,
    )
    gross = jnp.exp(term) - 1.0
    return cvar_frontier(
        np.asarray(gross), min_weights, max_weights, alpha=alpha, dtype=dtype, **kwargs
    )
