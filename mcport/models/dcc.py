"""DCC-GARCH(1,1): dynamic conditional correlations (Engle 2002).

Model-family upgrade over :mod:`mcport.models.garch_mc`'s CCC: real markets'
correlations RISE in stress, which constant-R models miss exactly where tail
risk lives. The DCC recursion drives a per-path pseudo-correlation state

    Q_t = (1 - a - b) S + a e_{t-1} e_{t-1}' + b Q_{t-1}
    R_t = diag(Q_t)^{-1/2} Q_t diag(Q_t)^{-1/2},   e_t ~ N(0, R_t)

on top of the SAME univariate GARCH(1,1) variance recursions (shared
estimation step — Engle's two-step QMLE: univariate fits first, then (a, b)
by maximizing the correlation log-likelihood of the standardized residuals).

Device mapping: the (a, b) likelihood surface is evaluated as ONE vmapped
``lax.scan`` over a feasible grid (coarse-to-fine; no line searches, no
data-dependent control flow). Simulation is a ``lax.scan`` whose per-path
(A, A) correlation state lives as A(A+1)/2 CONTIGUOUS (n,) lower-triangle
vectors, with the Cholesky unrolled (Cholesky-Banachiewicz, path batch as the
vector axis) into pure elementwise ops instead of a batched small-matrix
``linalg.cholesky`` per step. Memory is n_paths * A(A+1)/2 floats for the Q
carry; chunk paths at the caller for very large runs.

Reference anchor: the reference has no multivariate vol model at all
(GARCH(1,1) appears only in forecast bands, /root/reference/app.py:347-350);
this module extends mcport's model-family ladder
(GBM-normal/t -> CCC-GARCH(+t) -> DCC-GARCH -> jumps -> bootstrap).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.models.garch_mc import (
    CCCGarchParams,
    estimate_ccc_garch,
    standardized_residuals,
)

__all__ = ["DCCGarchParams", "estimate_dcc_garch", "dcc_terminal_returns",
           "dcc_path_stats", "dcc_risk"]


@dataclass(frozen=True)
class DCCGarchParams:
    """Univariate GARCH base + DCC correlation dynamics."""

    base: CCCGarchParams     # mu/omega/alpha/beta + unconditional corr chol(S)
    a_dcc: float             # news coefficient
    b_dcc: float             # persistence coefficient
    q0: np.ndarray           # (A, A) last fitted Q_T (simulation start)
    e0: np.ndarray           # (A,) last standardized residual

    @property
    def n_assets(self) -> int:
        return self.base.n_assets




@partial(jax.jit, static_argnames=())
def _dcc_loglik_grid(e: Array, s: Array, ab: Array) -> Array:
    """Correlation log-likelihood for each (a, b) row of ``ab`` -> (G,).

    ll = -0.5 sum_t [ log|R_t| + e_t' R_t^{-1} e_t - e_t' e_t ]  (Engle's
    second-step objective; the e'e term cancels the first-step density).
    """
    a_dim = e.shape[1]
    eye = jnp.eye(a_dim, dtype=e.dtype)

    def one(ab_row):
        a_c, b_c = ab_row[0], ab_row[1]

        def step(q, et):
            # Q uses e_{t-1}: fold the CURRENT residual in after scoring
            qn = jnp.clip(jnp.sqrt(jnp.diag(q)), 1e-6, None)
            r_t = q / jnp.outer(qn, qn)
            r_t = r_t + 1e-6 * eye                 # PSD guard for the solve
            chol = jnp.linalg.cholesky(r_t)
            sol = jax.scipy.linalg.cho_solve((chol, True), et)
            ll_t = -(2.0 * jnp.sum(jnp.log(jnp.diag(chol)))
                     + et @ sol - et @ et)
            q_next = (1.0 - a_c - b_c) * s + a_c * jnp.outer(et, et) + b_c * q
            return q_next, ll_t

        _, lls = jax.lax.scan(step, s, e)
        return 0.5 * jnp.sum(lls)

    return jax.vmap(one)(ab)


def _feasible_grid(a_lo, a_hi, b_lo, b_hi, n_a=13, n_b=17) -> np.ndarray:
    aa, bb = np.meshgrid(np.linspace(a_lo, a_hi, n_a),
                         np.linspace(b_lo, b_hi, n_b), indexing="ij")
    ab = np.stack([aa.ravel(), bb.ravel()], axis=1)
    return ab[(ab[:, 0] >= 0) & (ab[:, 1] >= 0) & (ab.sum(1) < 0.999)]


def estimate_dcc_garch(returns: np.ndarray) -> DCCGarchParams:
    """Two-step QMLE: univariate GARCH fits, then (a, b) by coarse-to-fine
    grid maximization of the vmapped correlation likelihood (two rounds —
    deterministic, compile-friendly, no data-dependent iteration counts)."""
    r = np.asarray(returns, np.float64)
    base = estimate_ccc_garch(r)
    e = standardized_residuals(r, base.mu, base.omega, base.alpha, base.beta)
    s = np.corrcoef(e, rowvar=False)
    s = np.atleast_2d(s) + 1e-9 * np.eye(e.shape[1])

    # ambient float width (f64 under x64, f32 otherwise — a grid ARGMAX is
    # insensitive to the difference, and explicit f64 warns when x64 is off)
    e_j = jnp.asarray(e)
    s_j = jnp.asarray(s)
    ab = _feasible_grid(0.0, 0.40, 0.0, 0.98, n_a=17, n_b=25)
    ll = np.asarray(_dcc_loglik_grid(e_j, s_j, jnp.asarray(ab)))
    a0, b0 = ab[int(np.argmax(ll))]
    ab2 = _feasible_grid(max(a0 - 0.03, 0.0), min(a0 + 0.03, 0.45),
                         max(b0 - 0.06, 0.0), min(b0 + 0.06, 0.995))
    ll2 = np.asarray(_dcc_loglik_grid(e_j, s_j, jnp.asarray(ab2)))
    a_c, b_c = (float(x) for x in ab2[int(np.argmax(ll2))])
    if a_c >= 0.44 or a_c + b_c >= 0.994:
        import warnings

        warnings.warn(
            f"DCC argmax sits on the search boundary (a={a_c:.3f}, "
            f"b={b_c:.3f}); the fitted dynamics may be clamped",
            stacklevel=2)

    # roll Q to Q_T (through e[0..T-2]): the SIMULATION's first step folds
    # e0 = e[-1] itself, so rolling any further would double-count the last
    # observed residual in the opening correlation state
    q = s.copy()
    for t in range(e.shape[0] - 1):
        q = (1.0 - a_c - b_c) * s + a_c * np.outer(e[t], e[t]) + b_c * q
    return DCCGarchParams(base=base, a_dcc=a_c, b_dcc=b_c, q0=q, e0=e[-1])


def _correlate_unrolled(q: Array, z: Array) -> Array:
    """``chol(R) @ z`` per path via an UNROLLED Cholesky-Banachiewicz
    (path batch as the vector axis). Kept as the tested reference form of
    the triangle math used inside :func:`_dcc_simulate`."""
    a = q.shape[-1]
    q_tri = {(i, j): q[:, i, j] for i in range(a) for j in range(i + 1)}
    cols = _chol_cols_from_tri(q_tri, a)
    out = jnp.zeros_like(z)
    for j in range(a):
        acc = jnp.zeros_like(z[:, 0])
        out = out.at[:, j].set(sum((cols[(j, k)] * z[:, k] for k in range(j + 1)),
                                   acc))
    return out


def _chol_cols_from_tri(q_tri, a: int):
    """Cholesky of the normalized correlation from lower-triangle (n,) entries.

    Returns ``{(i, j): L_ij}`` as contiguous (n,) vectors — A(A+1)/2
    elementwise ops, no (n, A, A) tensors, no strided slicing, fully fusable
    by XLA. Normalization (diag rescale to correlation) and PSD guards are
    applied here.
    """
    qn = {j: jnp.clip(jnp.sqrt(q_tri[(j, j)]), 1e-6, None) for j in range(a)}
    low: dict[tuple[int, int], Array] = {}
    for j in range(a):
        s = q_tri[(j, j)] / (qn[j] * qn[j]) + 1e-6     # R_jj with PSD guard
        for k in range(j):
            s = s - low[(j, k)] * low[(j, k)]
        d = jnp.sqrt(jnp.maximum(s, 1e-9))
        low[(j, j)] = d
        inv = 1.0 / d
        for i in range(j + 1, a):
            s2 = q_tri[(i, j)] / (qn[i] * qn[j])       # R_ij
            for k in range(j):
                s2 = s2 - low[(i, k)] * low[(j, k)]
            low[(i, j)] = s2 * inv
    return low


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def _dcc_simulate(
    key: Array, mu, omega, alpha, beta, s, q0, e0, sigma2_0, eps2_0,
    a_c, b_c, n_paths: int, n_steps: int, dtype=jnp.float32,
):
    a_dim = mu.shape[-1]
    tri = [(i, j) for i in range(a_dim) for j in range(i + 1)]

    def step(carry, t):
        sigma2, eps_prev2, e_cols, q_tri, cum = carry
        # correlation state from LAST period's standardized shocks —
        # element-wise on contiguous (n,) lower-triangle entries (an
        # (n, A, A) Q carry costs 3x the HBM traffic in strided slices)
        c0 = 1.0 - a_c - b_c
        q_tri = tuple(
            c0 * s[i, j] + a_c * e_cols[i] * e_cols[j] + b_c * q_tri[k]
            for k, (i, j) in enumerate(tri)
        )
        low = _chol_cols_from_tri(
            {ij: q_tri[k] for k, ij in enumerate(tri)}, a_dim)
        z = jax.random.normal(jax.random.fold_in(key, t), (n_paths, a_dim), dtype)
        e_cols = tuple(
            sum((low[(i, k)] * z[:, k] for k in range(1, i + 1)),
                low[(i, 0)] * z[:, 0])
            for i in range(a_dim)
        )                                                  # e_t ~ N(0, R_t)
        e = jnp.stack(e_cols, axis=1)
        sigma2 = omega + alpha * eps_prev2 + beta * sigma2
        eps = jnp.sqrt(jnp.maximum(sigma2, 0.0)) * e
        r_step = mu + eps
        cum = cum * (1.0 + r_step)
        return (sigma2, eps * eps, e_cols, q_tri, cum), None

    init = (
        jnp.broadcast_to(sigma2_0, (n_paths, a_dim)).astype(dtype),
        jnp.broadcast_to(eps2_0, (n_paths, a_dim)).astype(dtype),
        tuple(jnp.broadcast_to(e0[i], (n_paths,)).astype(dtype)
              for i in range(a_dim)),
        tuple(jnp.broadcast_to(q0[i, j], (n_paths,)).astype(dtype)
              for (i, j) in tri),
        jnp.ones((n_paths, a_dim), dtype),
    )
    (sigma2, _, _, _, cum), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return cum - 1.0


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def _dcc_path_stats_impl(
    key, mu, omega, alpha, beta, s, q0, e0, sigma2_0, eps2_0, a_c, b_c, w_t,
    n_paths: int, n_steps: int, dtype, hedge_args=None,
):
    a_dim = mu.shape[-1]
    tri = [(i, j) for i in range(a_dim) for j in range(i + 1)]
    hedged = hedge_args is not None
    if hedged:
        s0, ht, hk, hp, hq = hedge_args
        p0 = jnp.broadcast_to(jnp.asarray(s0, dtype), (n_paths, a_dim))
    else:
        p0 = jnp.ones((n_paths, a_dim), dtype)
    n_cand = w_t.shape[-1]

    def step(carry, t):
        sigma2, eps_prev2, e_cols, q_tri, p, v, peak, dd = carry
        c0 = 1.0 - a_c - b_c
        q_tri = tuple(
            c0 * s[i, j] + a_c * e_cols[i] * e_cols[j] + b_c * q_tri[k]
            for k, (i, j) in enumerate(tri)
        )
        low = _chol_cols_from_tri(
            {ij: q_tri[k] for k, ij in enumerate(tri)}, a_dim)
        z = jax.random.normal(jax.random.fold_in(key, t), (n_paths, a_dim), dtype)
        e_cols = tuple(
            sum((low[(i, k)] * z[:, k] for k in range(1, i + 1)),
                low[(i, 0)] * z[:, 0])
            for i in range(a_dim)
        )                                                  # e_t ~ N(0, R_t)
        e = jnp.stack(e_cols, axis=1)
        sigma2 = omega + alpha * eps_prev2 + beta * sigma2
        eps = jnp.sqrt(jnp.maximum(sigma2, 0.0)) * e
        r_t = mu + eps
        if hedged:
            from mcport.options.hedged import hedged_step_returns

            p_new = p * (1.0 + r_t)
            r_score = hedged_step_returns(p, p_new, ht, hk, hp, hq)
            p = p_new
        else:
            r_score = r_t
        v = v * (1.0 + r_score @ w_t)                      # (n, W)
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        return (sigma2, eps * eps, e_cols, q_tri, p, v, peak, dd), None

    init = (
        jnp.broadcast_to(sigma2_0, (n_paths, a_dim)).astype(dtype),
        jnp.broadcast_to(eps2_0, (n_paths, a_dim)).astype(dtype),
        tuple(jnp.broadcast_to(e0[i], (n_paths,)).astype(dtype)
              for i in range(a_dim)),
        tuple(jnp.broadcast_to(q0[i, j], (n_paths,)).astype(dtype)
              for (i, j) in tri),
        p0,
        jnp.ones((n_paths, n_cand), dtype),
        jnp.ones((n_paths, n_cand), dtype),
        jnp.zeros((n_paths, n_cand), dtype),
    )
    (*_, v, _, dd), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return (v - 1.0).T, dd.T


def dcc_path_stats(
    key: Array,
    params: DCCGarchParams,
    weights,
    n_paths: int,
    n_steps: int,
    dtype=jnp.float32,
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of W
    candidate portfolios over DCC-GARCH paths — the lax reference for
    :func:`mcport.ops.pallas_dcc.pallas_dcc_path_stats` (same model,
    independent stream; same triangle-vector Q carry as
    :func:`_dcc_simulate`).

    Candidates compound the per-period rebalanced wealth
    ``V_{t+1} = V_t (1 + w'r_t)`` (reference R·w semantics, app.py:710) with
    running peak/max-drawdown carries under DYNAMIC correlations — drawdown
    risk where it bites: correlations rising in stress. ``hedge_args``
    switches to hedged per-period settlement against the simulated price
    path (:func:`mcport.options.hedged.hedged_step_returns`)."""
    w = jnp.asarray(weights, dtype)
    if w.ndim == 1:
        w = w[None, :]
    b = params.base
    s = np.asarray(b.corr_chol) @ np.asarray(b.corr_chol).T
    return _dcc_path_stats_impl(
        key, jnp.asarray(b.mu, dtype), jnp.asarray(b.omega, dtype),
        jnp.asarray(b.alpha, dtype), jnp.asarray(b.beta, dtype),
        jnp.asarray(s, dtype), jnp.asarray(params.q0, dtype),
        jnp.asarray(params.e0, dtype), jnp.asarray(b.sigma2_0, dtype),
        jnp.asarray(b.eps2_0, dtype),
        jnp.asarray(params.a_dcc, dtype), jnp.asarray(params.b_dcc, dtype),
        w.T, n_paths, n_steps, dtype, hedge_args,
    )


def dcc_terminal_returns(
    key: Array, params: DCCGarchParams, n_paths: int, n_steps: int,
    dtype=jnp.float32,
) -> Array:
    """(n_paths, A) terminal compounded simple returns under DCC-GARCH(1,1)."""
    b = params.base
    s = np.asarray(b.corr_chol) @ np.asarray(b.corr_chol).T
    return _dcc_simulate(
        key, jnp.asarray(b.mu, dtype), jnp.asarray(b.omega, dtype),
        jnp.asarray(b.alpha, dtype), jnp.asarray(b.beta, dtype),
        jnp.asarray(s, dtype), jnp.asarray(params.q0, dtype),
        jnp.asarray(params.e0, dtype), jnp.asarray(b.sigma2_0, dtype),
        jnp.asarray(b.eps2_0, dtype),
        jnp.asarray(params.a_dcc, dtype), jnp.asarray(params.b_dcc, dtype),
        n_paths, n_steps, dtype,
    )


def dcc_risk(
    key: Array,
    params: DCCGarchParams,
    weights: np.ndarray,
    n_paths: int = 262_144,
    n_steps: int = 52,
    alpha: float = 0.95,
    dtype=jnp.float32,
) -> tuple[float, float, float]:
    """(var, cvar, port_mean) under DCC-GARCH, sketch-reduced like the CCC
    engine (shared covering log1p sketch — no clamping by construction)."""
    from mcport.config import COVERING_LOG1P_SKETCH as sketch
    from mcport.ops.quantile import histogram, sketch_var_cvar

    term = dcc_terminal_returns(key, params, n_paths, n_steps, dtype)
    port = term @ jnp.asarray(weights, dtype)
    v, c = sketch_var_cvar(histogram(port, sketch), alpha, sketch)
    return float(v), float(c), float(port.mean())
