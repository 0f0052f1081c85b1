"""Exact efficient frontier via projected-gradient QP (beyond random search).

The reference's only optimizer is 2,500 random Dirichlet draws + argmax
(app.py:699-717); mcport's batched searches scale that paradigm to millions of
candidates. This module adds the *exact* counterpart: the box-constrained
mean-variance frontier

    min_w  w' Sigma w - lam * mu' w      s.t.  sum w = 1,  lo <= w <= hi

solved for a sweep of risk-aversion parameters ``lam`` by Nesterov-accelerated
projected gradient descent — each subproblem is convex (L = 2 lammax(Sigma)),
the projection onto the capped simplex is a vectorized bisection, and the whole
lam-sweep runs as ONE vmapped program (the (L, A) iterates are one batched matmul).
Max-Sharpe / min-variance / target-risk optima read off the swept frontier.

Device mapping: no data-dependent Python control flow — fixed-iteration Nesterov
loop (`lax.fori_loop`), fixed-iteration bisection, power iteration for lammax.
Everything jits once for a given (A, n_lambda).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = [
    "project_capped_simplex",
    "ExactFrontier",
    "exact_frontier",
    "max_sharpe_exact",
    "min_variance_exact",
    "target_risk_exact",
]


@partial(jax.jit, static_argnames=("n_iter",))
def project_capped_simplex(
    y: Array, lo: Array, hi: Array, n_iter: int = 60
) -> Array:
    """Euclidean projection onto {w : sum w = 1, lo <= w <= hi}.

    w_i(tau) = clip(y_i - tau, lo_i, hi_i) with sum w(tau) strictly decreasing
    in tau; 60 bisection steps resolve tau to ~1e-16 of the bracket. Requires
    feasibility (sum lo <= 1 <= sum hi); infeasible bounds saturate at the
    nearer box corner (callers validate feasibility like the samplers do).
    """
    y = jnp.asarray(y)
    lo = jnp.broadcast_to(jnp.asarray(lo, y.dtype), y.shape)
    hi = jnp.broadcast_to(jnp.asarray(hi, y.dtype), y.shape)
    # tau bracket: sum(clip(y - tau)) = 1 is attained within these extremes
    t_lo = jnp.min(y - hi)   # tau <= t_lo → w = hi everywhere → sum >= 1
    t_hi = jnp.max(y - lo)   # tau >= t_hi → w = lo everywhere → sum <= 1

    def body(_, ab):
        a, b = ab
        mid = 0.5 * (a + b)
        s = jnp.sum(jnp.clip(y - mid, lo, hi), axis=-1)
        too_big = s > 1.0    # need larger tau
        return jnp.where(too_big, mid, a), jnp.where(too_big, b, mid)

    a, b = jax.lax.fori_loop(0, n_iter, body, (t_lo, t_hi))
    return jnp.clip(y - 0.5 * (a + b), lo, hi)


def _lambda_max(sigma: Array, n_iter: int = 64) -> Array:
    """Largest eigenvalue via power iteration (deterministic start)."""
    a = sigma.shape[-1]
    v = jnp.ones((a,), sigma.dtype) / jnp.sqrt(jnp.asarray(a, sigma.dtype))

    def body(_, v):
        w = sigma @ v
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, n_iter, body, v)
    return v @ sigma @ v


@partial(jax.jit, static_argnames=("n_iter",))
def _solve_qp_sweep(
    sigma: Array, mu: Array, lams: Array, lo: Array, hi: Array, n_iter: int = 600
) -> Array:
    """Nesterov PGD for min w'Σw - lam mu'w over the capped simplex, vmapped
    over the lam sweep → (L, A) optimal weights."""
    step = 1.0 / (2.0 * _lambda_max(sigma) + 1e-30)

    def solve(lam):
        w0 = project_capped_simplex(jnp.full_like(mu, 1.0 / mu.shape[-1]), lo, hi)

        def body(k, carry):
            w, z = carry                       # iterate + momentum point
            grad = 2.0 * (sigma @ z) - lam * mu
            w_new = project_capped_simplex(z - step * grad, lo, hi)
            beta = k / (k + 3.0)               # Nesterov momentum schedule
            z_new = w_new + beta * (w_new - w)
            return w_new, z_new

        w, _ = jax.lax.fori_loop(0, n_iter, body, (w0, w0))
        return w

    return jax.vmap(solve)(lams)


@dataclass(frozen=True)
class ExactFrontier:
    """Swept box-constrained mean-variance frontier."""

    lams: np.ndarray       # (L,) risk-aversion sweep
    weights: np.ndarray    # (L, A)
    ret: np.ndarray        # (L,) annualized expected return mu'w
    std: np.ndarray        # (L,) annualized volatility sqrt(w'Σw)
    sharpe: np.ndarray     # (L,) (ret - rf)/std
    risk_free: float

    def _pick(self, idx: int) -> tuple[np.ndarray, float, float]:
        return self.weights[idx], float(self.ret[idx]), float(self.std[idx])


def exact_frontier(
    mean_ann: np.ndarray,
    cov_ann: np.ndarray,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    risk_free: float = 0.0,
    n_lambda: int = 64,
    lam_max: float | None = None,
    n_iter: int = 600,
) -> ExactFrontier:
    """Solve the constrained frontier for a log-spaced risk-aversion sweep.

    lam=0 is the minimum-variance portfolio; large lam approaches the
    max-return corner. ``lam_max`` defaults to a scale-aware value
    (100 * lammax(Σ) / max|mu|) that reaches the return-dominated end.
    """
    mu = np.asarray(mean_ann, np.float64)
    sigma = np.asarray(cov_ann, np.float64)
    a = mu.shape[-1]
    lo = np.zeros(a) if min_weights is None else np.asarray(min_weights, np.float64)
    hi = np.ones(a) if max_weights is None else np.asarray(max_weights, np.float64)
    if lo.sum() > 1.0 + 1e-9 or hi.sum() < 1.0 - 1e-9:
        raise ValueError("infeasible weight bounds: need sum(min) <= 1 <= sum(max)")
    if lam_max is None:
        lam_max = 100.0 * float(np.linalg.eigvalsh(sigma).max()) / max(
            float(np.abs(mu).max()), 1e-12
        )
    # lam sweep: 0 (min-variance) + log-spaced up to lam_max
    lams = np.concatenate([[0.0], np.geomspace(lam_max / 1e4, lam_max, n_lambda - 1)])

    w = np.asarray(_solve_qp_sweep(
        jnp.asarray(sigma), jnp.asarray(mu), jnp.asarray(lams),
        jnp.asarray(lo), jnp.asarray(hi), n_iter,
    ))
    ret = w @ mu
    std = np.sqrt(np.maximum(np.einsum("la,ab,lb->l", w, sigma, w), 0.0))
    sharpe = np.where(std > 0, (ret - risk_free) / np.where(std > 0, std, 1.0), 0.0)
    return ExactFrontier(lams=lams, weights=w, ret=ret, std=std, sharpe=sharpe,
                         risk_free=risk_free)


def max_sharpe_exact(frontier: ExactFrontier) -> tuple[np.ndarray, float, float]:
    """(weights, ret, std) of the frontier point with the highest Sharpe."""
    return frontier._pick(int(np.argmax(frontier.sharpe)))


def min_variance_exact(frontier: ExactFrontier) -> tuple[np.ndarray, float, float]:
    return frontier._pick(int(np.argmin(frontier.std)))


def target_risk_exact(
    frontier: ExactFrontier, target: float = 0.30
) -> tuple[np.ndarray, float, float]:
    """Max return among frontier points with std <= target; nearest-std
    fallback when the whole frontier exceeds the target (the weight_search
    target-risk semantics)."""
    feasible = frontier.std <= target
    if feasible.any():
        idx = int(np.argmax(np.where(feasible, frontier.ret, -np.inf)))
    else:
        idx = int(np.argmin(np.abs(frontier.std - target)))
    return frontier._pick(idx)
