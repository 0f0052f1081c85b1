"""Pathwise risk sensitivities (Greeks) by differentiating THROUGH the simulation.

The reference computes no sensitivities of any kind — its optimum is a pick
over randomly sampled weights (/root/reference/app.py:699-747), and its option
analytics stop at terminal payoff curves (app.py:195-229). A JAX-native
framework gets exact sensitivities almost for free: the whole simulation
pipeline (counter-addressed draws → Cholesky correlate → compounding →
option settlement → tail metrics) is one differentiable function of the
weights, the model parameters, and the spot prices, so every Greek is one
``jax.grad`` — a single reverse pass, not 2·K bumped re-simulations, and
bias-free where finite differences are not.

Estimator notes (the math that makes the autodiff output a VALID estimator):

* **Reparameterization.** The draws depend only on the PRNG key, never on the
  differentiated parameters — ``terminal = f(params, z)`` with ``z`` fixed —
  so pathwise derivatives are unbiased for any a.e.-differentiable,
  Lipschitz payoff (Glasserman, *MC Methods in Financial Engineering*, ch. 7).
  Option legs are piecewise-LINEAR in the terminal price (max(S−K,0)-style,
  app.py:164-180), hence Lipschitz: delta and vega are pathwise-valid.
  Second derivatives (gamma) are NOT — the pathwise second derivative of a
  kinked payoff is zero a.e.; this module deliberately exposes first-order
  Greeks only.
* **VaR / CVaR.** With k = ceil((1−α)·N) (the repo's simulated-tier
  convention, `cvar_opt.exact_tail_metrics`), ``VaR = −top_k(−port)[k−1]``
  differentiates to the scenario row at the VaR boundary (the
  E[r | port = VaR] estimator), and ``CVaR`` to the tail-average row —
  exactly the Euler components of `engine.attribution` divided by the
  weights. Both metrics are positively homogeneous degree 1 in ``w``, so
  ``w·∇_w VaR = VaR`` and ``w·∇_w CVaR = CVaR`` hold to float precision —
  reported as ``euler_gap_*`` self-diagnostics.
* **Streams.** Sensitivities re-simulate with the lax tier (scan +
  fold_in-per-step, `models.gbm.terminal_log_returns`), which XLA
  differentiates end-to-end; the fused kernels are primal-only by
  design. Same law as the kernel engines, independent stream — documented
  framework-wide convention.

Scale note: one reverse pass stores the scan residuals (O(paths · A) per
step before remat), so analysis-scale path counts (≤ ~2^20) run comfortably
on one chip; `jax.checkpoint` on the step keeps memory at O(paths · A)
total. The quantile-sketch streaming tier is deliberately NOT differentiated
(its clamped-grid counts are piecewise constant); Greeks use the exact
top-k tail on materialized terminals.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.config import GBMConfig
from mcport.models.gbm import GBMParams, _student_t_polar

__all__ = [
    "PortfolioSensitivities",
    "HedgedSensitivities",
    "portfolio_sensitivities",
    "hedged_sensitivities",
    "hedged_mean_gamma",
    "terminal_sensitivities",
    "TerminalSensitivities",
    "terminal_log_remat",
]


@dataclass(frozen=True)
class PortfolioSensitivities:
    """First-order sensitivities of (mean, VaR_α, CVaR_α) of the terminal
    portfolio return. ``d_*_dw`` are (A,) gradients w.r.t. the weights;
    ``d_*_dmu`` w.r.t. the per-step drift vector; ``d_*_dvol`` w.r.t. a
    per-asset RELATIVE volatility bump (``∂/∂s_a`` of scaling asset a's
    Cholesky row by ``s_a``, evaluated at s = 1) — the simulated vega.
    ``euler_gap_*`` are |w·∇_w − metric| self-diagnostics (0 to float
    precision; a large gap means the estimate is unreliable)."""

    mean: float
    var: float
    cvar: float
    d_mean_dw: np.ndarray
    d_var_dw: np.ndarray
    d_cvar_dw: np.ndarray
    d_mean_dmu: np.ndarray
    d_var_dmu: np.ndarray
    d_cvar_dmu: np.ndarray
    d_mean_dvol: np.ndarray
    d_var_dvol: np.ndarray
    d_cvar_dvol: np.ndarray
    euler_gap_var: float
    euler_gap_cvar: float
    alpha: float
    n_paths: int


@dataclass(frozen=True)
class HedgedSensitivities:
    """Adds the spot-price Greeks of a HEDGED portfolio (options settle at
    intrinsic value against simulated terminal prices): ``d_*_ds0`` is the
    (A,) pathwise delta — return units per absolute price unit of each
    asset's spot."""

    base: PortfolioSensitivities
    d_mean_ds0: np.ndarray
    d_var_ds0: np.ndarray
    d_cvar_ds0: np.ndarray


def _tail_k(n_paths: int, alpha: float) -> int:
    return max(1, math.ceil((1.0 - alpha) * n_paths))


def _metrics(port: Array, k: int) -> Array:
    """[mean, VaR, CVaR] of one (N,) portfolio return vector — the
    exact_tail_metrics convention (k-th worst / k-worst mean)."""
    worst, _ = jax.lax.top_k(-port, k)
    return jnp.stack([port.mean(), -worst[k - 1], -worst.mean()])


def terminal_log_remat(key: Array, mu: Array, chol: Array, n_paths: int,
                       n_steps: int, antithetic: bool = False,
                       t_df: float | None = None) -> Array:
    """(N, A) terminal log returns, differentiable in (mu, chol).

    Same law, stream structure (fold_in per step), and antithetic convention
    as :func:`mcport.models.gbm.terminal_log_returns` /
    ``terminal_log_returns_t``, re-stated here with ``jax.checkpoint`` on the
    step: the reverse pass then RE-DRAWS each step's z instead of storing a
    (paths, A) residual per step — O(paths·A) total memory instead of
    O(paths·A·steps) (~2 GB at the 131k×252 default), trading one cheap PRNG
    re-evaluation per step for HBM. Shared with the mesh form
    (:mod:`mcport.parallel.sharded_greeks`), which calls it per device."""
    lt = chol.T
    a = mu.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    if t_df is not None:
        scale = 1.0 / jnp.sqrt(jnp.asarray(t_df / (t_df - 2.0), jnp.float32))

    @jax.checkpoint
    def step(carry, t):
        zk = jax.random.fold_in(key, t)
        if t_df is not None:
            z = _student_t_polar(zk, t_df, (half, a), jnp.float32) * scale
        else:
            z = jax.random.normal(zk, (half, a), jnp.float32)
        if antithetic:
            z = jnp.concatenate([z, -z], axis=0)
        return carry + mu + z @ lt, None

    init = jnp.zeros((half * 2 if antithetic else n_paths, a), jnp.float32)
    out, _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return out


def _terminal_log(config: GBMConfig, mu: Array, chol: Array) -> Array:
    t_df = (float(config.t_dof)
            if config.innovations == "student_t" else None)
    if config.qmc != "none":
        # GBM's terminal log return is exactly Gaussian (N(n·mu, n·LL')), so
        # the QMC estimator draws ONE low-discrepancy normal per path
        # (terminal_log_returns_exact convention) — the points are fixed
        # (parameter-independent), so the reparameterized gradients stay
        # valid and inherit the full QMC variance reduction.
        if t_df is not None:
            raise ValueError("QMC sensitivities draw Gaussian terminals; "
                             "use innovations='normal' or qmc='none'")
        if config.antithetic:
            raise ValueError("antithetic is redundant under QMC; disable one")
        from mcport.models.qmc import qmc_normals

        z = qmc_normals(config.n_paths, mu.shape[-1], config.qmc, config.seed)
        z = jax.lax.stop_gradient(z)
        scale = jnp.sqrt(jnp.asarray(config.n_steps, jnp.float32))
        return config.n_steps * mu + scale * (z @ chol.T)
    return terminal_log_remat(jax.random.key(config.seed), mu, chol,
                              config.n_paths, config.n_steps,
                              antithetic=config.antithetic, t_df=t_df)


def _value_and_jac(metrics, *args):
    """(values, per-arg jacobians) in ONE forward pass: jax.vjp gives the
    primal and the pullback together (jacrev followed by a separate value
    call would rely on XLA CSE deduplicating the whole remat'd scan — a
    known blind spot — to avoid paying a second simulation)."""
    vals, pullback = jax.vjp(metrics, *args)
    eye = jnp.eye(vals.shape[0], dtype=vals.dtype)
    rows = [pullback(eye[i]) for i in range(vals.shape[0])]
    jac = tuple(jnp.stack([r[k] for r in rows]) for k in range(len(args)))
    return vals, jac


@functools.partial(jax.jit, static_argnames=("config", "k", "hedged"))
def _all_grads(w, mu, chol, vol_scale, s0, hedge_arrays, config: GBMConfig,
               k: int, hedged: bool):
    """Values + Jacobian of [mean, VaR, CVaR] w.r.t. (w, mu, vol_scale, s0)
    — one forward, three reverse passes through the shared graph."""

    def metrics(w, mu, vol_scale, s0):
        term_log = _terminal_log(config, mu, vol_scale[:, None] * chol)
        if hedged:
            from mcport.options.hedged import hedged_terminal_returns

            gross = hedged_terminal_returns(term_log, s0, *hedge_arrays)
        else:
            gross = jnp.exp(term_log) - 1.0
        return _metrics(gross @ w, k)

    return _value_and_jac(metrics, w, mu, vol_scale, s0)


def portfolio_sensitivities(
    params: GBMParams,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> PortfolioSensitivities | HedgedSensitivities:
    """Pathwise ∂(mean, VaR, CVaR)/∂(weights, drift, vol[, spot]) of the
    simulated terminal portfolio return.

    ``hedge`` (a :class:`mcport.options.hedged.HedgeSpec`) + ``s0`` switch to
    the hedged terminal composition (options settle at intrinsic against
    ``S_T = s0·exp(term_log)``) and add per-asset spot deltas. Innovations
    follow ``config.innovations`` (normal | student_t) — the Student-t polar
    draws are also parameter-independent, so the reparameterized gradients
    stay valid.
    """
    w = jnp.asarray(weights, jnp.float32)
    mu = jnp.asarray(params.mean_step, jnp.float32)
    chol = jnp.asarray(params.chol_step, jnp.float32)
    a = int(mu.shape[-1])
    if w.shape != (a,):
        raise ValueError(f"weights must be ({a},), got {tuple(w.shape)}")
    hedged = hedge is not None
    if hedged and s0 is None:
        raise ValueError("hedged sensitivities require s0 (asset spot prices)")
    s0_arr = (jnp.asarray(s0, jnp.float32) if s0 is not None
              else jnp.ones((a,), jnp.float32))
    hedge_arrays = hedge.arrays if hedged else ()
    vol_scale = jnp.ones((a,), jnp.float32)
    k = _tail_k(config.n_paths, alpha)

    vals, jac = _all_grads(w, mu, chol, vol_scale, s0_arr, hedge_arrays,
                           config, k, hedged)
    return pack_sensitivities(vals, jac, weights, alpha, config.n_paths,
                              hedged)


def pack_sensitivities(vals, jac, weights, alpha: float, n_paths: int,
                       hedged: bool) -> PortfolioSensitivities | HedgedSensitivities:
    """Assemble the result dataclasses from (values, (d_w, d_mu, d_vol[, d_s0]))
    — shared by the single-chip and mesh (parallel.sharded_greeks) tiers so
    the Euler-gap convention and field layout cannot diverge."""
    vals = np.asarray(vals, np.float64)
    d_w, d_mu, d_vol = (np.asarray(jac[i], np.float64) for i in range(3))
    mean, var, cvar = (float(v) for v in vals)
    w64 = np.asarray(weights, np.float64)
    base = PortfolioSensitivities(
        mean=mean, var=var, cvar=cvar,
        d_mean_dw=d_w[0], d_var_dw=d_w[1], d_cvar_dw=d_w[2],
        d_mean_dmu=d_mu[0], d_var_dmu=d_mu[1], d_cvar_dmu=d_mu[2],
        d_mean_dvol=d_vol[0], d_var_dvol=d_vol[1], d_cvar_dvol=d_vol[2],
        euler_gap_var=abs(float(w64 @ d_w[1]) - var),
        euler_gap_cvar=abs(float(w64 @ d_w[2]) - cvar),
        alpha=alpha, n_paths=n_paths,
    )
    if not hedged:
        return base
    d_s0 = np.asarray(jac[3], np.float64)
    return HedgedSensitivities(
        base=base, d_mean_ds0=d_s0[0], d_var_ds0=d_s0[1], d_cvar_ds0=d_s0[2])


def hedged_sensitivities(
    params: GBMParams,
    weights: np.ndarray,
    hedge,
    s0: np.ndarray,
    config: GBMConfig = GBMConfig(),
    alpha: float = 0.95,
) -> HedgedSensitivities:
    """Convenience wrapper: :func:`portfolio_sensitivities` with a hedge."""
    out = portfolio_sensitivities(params, weights, config, alpha,
                                  hedge=hedge, s0=s0)
    assert isinstance(out, HedgedSensitivities)
    return out


# ---------------------------------------------------------------------------
# family tier: weight (and hedged spot) gradients for ANY terminal law
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TerminalSensitivities:
    """Weight (and, hedged, spot) gradients of (mean, VaR, CVaR) against a
    precomputed (N, A) terminal simple-return matrix — the tier every model
    family supports (GARCH/DCC/jump/bootstrap terminals are not
    reparameterizable in their fitted parameters the way GBM's are, but the
    portfolio composition and the option settlement still differentiate)."""

    mean: float
    var: float
    cvar: float
    d_mean_dw: np.ndarray
    d_var_dw: np.ndarray
    d_cvar_dw: np.ndarray
    euler_gap_var: float
    euler_gap_cvar: float
    alpha: float
    n_paths: int
    d_mean_ds0: np.ndarray | None = None
    d_var_ds0: np.ndarray | None = None
    d_cvar_ds0: np.ndarray | None = None


@functools.partial(jax.jit, static_argnames=("k", "hedged"))
def _terminal_grads(simple, w, s0, hedge_arrays, k: int, hedged: bool):
    def metrics(w, s0):
        if hedged:
            from mcport.options.hedged import hedged_from_simple

            gross = hedged_from_simple(simple, s0, *hedge_arrays)
        else:
            gross = simple
        return _metrics(gross @ w, k)

    return _value_and_jac(metrics, w, s0)


def terminal_sensitivities(
    simple_terminal,
    weights: np.ndarray,
    alpha: float = 0.95,
    hedge=None,
    s0: np.ndarray | None = None,
) -> TerminalSensitivities:
    """Pathwise ∂(mean, VaR, CVaR)/∂weights (+ ∂/∂s0 when hedged) of ANY
    (N, A) terminal simple-return matrix — GARCH, DCC, Merton-jump,
    bootstrap, or anything else. The hedged composition settles option legs
    at intrinsic against ``S_T = s0·(1 + r)`` (the ``hedged_from_simple``
    convention shared with :func:`mcport.api.hedged_tail_risk`)."""
    simple = jnp.asarray(simple_terminal, jnp.float32)
    n, a = simple.shape
    w = jnp.asarray(weights, jnp.float32)
    hedged = hedge is not None
    if hedged and s0 is None:
        raise ValueError("hedged sensitivities require s0 (asset spot prices)")
    s0_arr = (jnp.asarray(s0, jnp.float32) if s0 is not None
              else jnp.ones((a,), jnp.float32))
    k = _tail_k(n, alpha)
    vals, jac = _terminal_grads(simple, w, s0_arr,
                                hedge.arrays if hedged else (), k, hedged)
    vals = np.asarray(vals, np.float64)
    d_w = np.asarray(jac[0], np.float64)
    mean, var, cvar = (float(v) for v in vals)
    w64 = np.asarray(weights, np.float64)
    out = dict(
        mean=mean, var=var, cvar=cvar,
        d_mean_dw=d_w[0], d_var_dw=d_w[1], d_cvar_dw=d_w[2],
        euler_gap_var=abs(float(w64 @ d_w[1]) - var),
        euler_gap_cvar=abs(float(w64 @ d_w[2]) - cvar),
        alpha=alpha, n_paths=n,
    )
    if hedged:
        d_s0 = np.asarray(jac[1], np.float64)
        out.update(d_mean_ds0=d_s0[0], d_var_ds0=d_s0[1], d_cvar_ds0=d_s0[2])
    return TerminalSensitivities(**out)


# ---------------------------------------------------------------------------
# second order: gamma by likelihood ratio (pathwise is invalid at the kink)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("config",))
def _lr_gamma_core(mu, chol, s0, hedge_arrays, config: GBMConfig):
    from mcport.options.hedged import hedged_terminal_returns

    x = _terminal_log(config, mu, chol)                  # (N, A)
    r = hedged_terminal_returns(x, s0, *hedge_arrays)    # (N, A)
    u = jnp.expm1(x)                                     # control variate
    n = jnp.asarray(config.n_steps, jnp.float32)
    centered = (x - config.n_steps * mu).T               # (A, N)
    lfac = jnp.sqrt(n) * chol                            # V = lfac lfac^T
    g = jax.scipy.linalg.cho_solve((lfac, True), centered).T   # (N, A)
    vinv_diag = jnp.diagonal(
        jax.scipy.linalg.cho_solve((lfac, True), jnp.eye(mu.shape[-1],
                                                         dtype=mu.dtype)))
    samples = (r - u) * (g * g - vinv_diag - 3.0 * g + 2.0)    # (N, A)
    core = jnp.mean(samples, axis=0)                     # (A,) E[(r-u)·t]
    # standard error over the INDEPENDENT units: antithetic rows are N/2
    # correlated pairs (row i mirrors row N/2+i in terminal_log_remat's
    # [z, -z] layout), so the se averages each pair first; QMC points are
    # not iid at all — no meaningful se exists (NaN, documented).
    if config.qmc != "none":
        se = jnp.full(core.shape, jnp.nan, core.dtype)
    elif config.antithetic:
        half = samples.shape[0] // 2
        pair = 0.5 * (samples[:half] + samples[half:])
        se = jnp.std(pair, axis=0, ddof=1) / jnp.sqrt(half)
    else:
        se = jnp.std(samples, axis=0, ddof=1) / jnp.sqrt(samples.shape[0])
    return core, se


def hedged_mean_gamma(
    params: GBMParams,
    weights: np.ndarray,
    hedge,
    s0: np.ndarray,
    config: GBMConfig = GBMConfig(),
) -> tuple[np.ndarray, np.ndarray]:
    """Per-asset GAMMA of the hedged portfolio's mean return:
    ``∂²mean/∂s0_a²`` — by the likelihood-ratio method, because the pathwise
    second derivative of a kinked (piecewise-linear) payoff is zero a.e. and
    therefore invalid. Returns ``(gamma (A,), standard_error (A,))``.

    Derivation sketch (full derivation in tests/test_greeks.py's closed-form
    pin): GBM's terminal log X is exactly Gaussian, S = s0·e^X, and the
    s0-shift moves into the density, so with the score
    ``g = V^{-1}(X − n·mu)``, ``t = g² − V^{-1}_aa − 3g + 2``:

        gamma_a = (w_a / s0_a²) · ( E[(r_a − u_a)·t_a] − 2 − 2·β_a )

    where ``u = e^X − 1`` is a control variate with the known value
    ``E[u·t] = −2`` (it removes the S-linear component: an UNHEDGED asset's
    gamma comes out structurally zero, not zero-in-expectation), and ``β_a``
    counts the legs whose payoff references s0 explicitly
    (−qty per buy-asset, +qty per sell-asset/sell-futures — their
    ``β·s0`` term has no curvature). Requires Gaussian terminals
    (``innovations='normal'``); QMC points are fine (fixed-point
    integration of the same integrand).
    """
    if config.innovations == "student_t":
        raise ValueError("LR gamma needs the Gaussian score; "
                         "innovations='student_t' is not supported")
    if hedge is None:
        raise ValueError("hedged_mean_gamma requires a HedgeSpec")
    mu = jnp.asarray(params.mean_step, jnp.float32)
    chol = jnp.asarray(params.chol_step, jnp.float32)
    w = np.asarray(weights, np.float64)
    s0_np = np.asarray(s0, np.float64)

    core, se = _lr_gamma_core(mu, chol, jnp.asarray(s0, jnp.float32),
                              hedge.arrays, config)
    type_id, qty = np.asarray(hedge.type_id), np.asarray(hedge.qty)
    beta = (qty * np.isin(type_id, (1, 6)) - qty * (type_id == 0)).sum(axis=1)
    scale = w / s0_np**2
    gamma = scale * (np.asarray(core, np.float64) - 2.0 - 2.0 * beta)
    return gamma, np.abs(scale) * np.asarray(se, np.float64)
