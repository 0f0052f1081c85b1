"""Heston stochastic-volatility model family — pure ``jax.lax`` reference tier.

Reference anchor: the reference's tail estimator is the historical percentile
of realized returns (/root/reference/app.py:258-263) and its "Monte Carlo"
never simulates paths (SURVEY.md §2 "GBM is implied, not implemented"). This
module extends the BASELINE.json:5 correlated-path mandate with the seventh
model family: continuous-time stochastic volatility. Where CCC/DCC-GARCH make
variance a deterministic function of past shocks, Heston gives variance its
OWN diffusion with mean reversion and a leverage correlation — the standard
continuous-time description of volatility risk (Heston 1993), discretized per
analysis period like every other family so it plugs into the same path tier.

Per-asset square-root (CIR) variance with cross-asset correlated return
shocks, full-truncation Euler (dt = 1 analysis period):

    x_{t,a}   = (mu_a - v+_{t,a}/2) + sqrt(v+_{t,a}) zc_{t,a}    (log return)
    v_{t+1,a} = v_{t,a} + kappa_a (theta_a - v+_{t,a})
                + xi_a sqrt(v+_{t,a}) zv_{t,a}
    zc = L_R z,  zv_a = rho_a zc_a + sqrt(1 - rho_a^2) w_a

with z, w ~ N(0, I) and v+ = max(v, 0) (full truncation — the standard
bias-minimal Euler scheme for CIR; Lord, Koekkoek & van Dijk 2010). ``rho_a``
correlates each asset's return shock with its OWN variance shock (leverage:
crashes raise vol), and L_R correlates return shocks across assets.

With xi = 0 and v0 = theta the variance is frozen and the model reduces
exactly to the GBM family's per-step law (mu - theta/2 drift, sqrt(theta)
vol) — the reduction is pinned by tests.

Calibration (``estimate_heston``) is a two-stage estimator (round 5): a
moment match on squared demeaned returns provides the init, then the
leverage-filter QMLE (:func:`fit_heston_qmle`) refines (mu, kappa, theta,
xi*rho) — exact MLE of a latent-variance diffusion needs a particle filter
(out of scope); the filtered quasi-likelihood is the standard return-only
middle ground and is recovery-tested at n=300/1000 with documented
small-sample bias (tests/test_heston_recovery.py). The moment stage:

- theta  = Var(r)                     (stationary E[v]; ddof=1, app.py:679-680
                                       estimator semantics)
- phi    = acf_2(r^2) / acf_1(r^2)    (the measurement-noise-cancelling AR(1)
                                       ratio; kappa = 1 - phi)
- Var(v) = E[r^4]/3 - theta^2         (Gaussian conditional kurtosis)
- xi     = sqrt(2 kappa Var(v) / theta), capped at the Feller bound
           sqrt(2 kappa theta)
- rho    = Cov(r_t, r_{t+1}^2) / (xi theta)   (leverage moment), clipped
- R      = corr of EWMA-standardized returns (RiskMetrics lambda = 0.94)
- v0     = last EWMA variance (today's vol state, not the long-run mean)

Device mapping: a ``lax.scan`` over steps with two normal draws per step
(the return and the variance shocks) and (paths, A) price and variance
carries.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = [
    "HestonParams",
    "estimate_heston",
    "fit_heston_qmle",
    "simulate_heston_returns",
    "heston_terminal_returns",
    "heston_path_stats",
    "EWMA_LAMBDA",
]

EWMA_LAMBDA = 0.94   # RiskMetrics decay for the variance proxy / v0


@dataclass(frozen=True)
class HestonParams:
    """Per-asset CIR variance + leverage, cross-asset shock correlation.

    All rate parameters are per analysis step (dt = 1 period), matching the
    per-step convention of every other family (GBMParams.mean_step etc.).
    """

    mu: np.ndarray          # (A,) per-step log drift (Ito-complete: E[x] = mu - v/2)
    kappa: np.ndarray       # (A,) variance mean-reversion speed per step
    theta: np.ndarray       # (A,) long-run variance per step
    xi: np.ndarray          # (A,) vol-of-vol per step
    rho: np.ndarray         # (A,) leverage corr(return shock, variance shock)
    v0: np.ndarray          # (A,) initial variance (today's state)
    corr_chol: np.ndarray   # (A, A) Cholesky of the cross-asset shock corr R
    s0: np.ndarray          # (A,) spot prices

    @property
    def n_assets(self) -> int:
        return self.mu.shape[-1]


def _ewma_variance(logret: np.ndarray, lam: float = EWMA_LAMBDA) -> np.ndarray:
    """(T, A) EWMA variance proxy, seeded at the sample variance."""
    eps = logret - logret.mean(axis=0)
    v = np.empty_like(eps)
    v[0] = eps.var(axis=0)
    for t in range(1, eps.shape[0]):
        v[t] = lam * v[t - 1] + (1.0 - lam) * eps[t - 1] ** 2
    return v


def estimate_heston(
    prices: np.ndarray, jitter: float = 1e-10, method: str = "qmle",
) -> HestonParams:
    """Heston calibration from a (T, A) price matrix.

    ``method="qmle"`` (production default, round 5) runs the moment match
    below and then refines (mu, kappa, theta, xi*rho) by the leverage-filter
    quasi-likelihood (:func:`fit_heston_qmle`) — measured to cut the kappa
    median error ~10x and recover the leverage sign on every seed at
    n=300/1000 (tests/test_heston_recovery.py). ``method="moment"`` is the
    raw moment match (kept as the init/fallback tier).

    Moment conditions (see the module docstring): the acf-ratio kappa
    estimator is noisy on short histories; estimates are clipped to sane
    ranges (kappa in [1e-3, 1.5], xi at the Feller bound, |rho| <= 0.95) so
    the simulation never leaves the regime the full-truncation scheme
    handles gracefully. Degenerate series (no excess kurtosis) degrade
    toward xi ~ 0, i.e. plain GBM.
    """
    if method not in ("qmle", "moment"):
        raise ValueError(f"method must be 'qmle' or 'moment', got {method!r}")
    if method == "qmle":
        return fit_heston_qmle(prices, jitter=jitter)
    prices = np.asarray(prices, np.float64)
    if prices.ndim != 2 or prices.shape[0] < 20:
        raise ValueError("estimate_heston needs a (T>=20, A) price matrix")
    logret = np.diff(np.log(prices), axis=0)            # (T-1, A)
    t_len, a = logret.shape
    eps = logret - logret.mean(axis=0)

    theta = logret.var(axis=0, ddof=1)
    theta = np.maximum(theta, 1e-12)

    # kappa from the noise-cancelling acf ratio of squared returns
    sq = eps**2
    sqc = sq - sq.mean(axis=0)

    def autocov(lag: int) -> np.ndarray:
        return (sqc[:-lag] * sqc[lag:]).mean(axis=0)

    c1, c2 = autocov(1), autocov(2)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = np.where(c1 > 0, c2 / np.maximum(c1, 1e-300), 0.5)
    phi = np.clip(np.nan_to_num(phi, nan=0.5), 0.0, 0.999)
    kappa = np.clip(1.0 - phi, 1e-3, 1.5)

    # vol-of-vol from conditional-Gaussian kurtosis, Feller-capped
    var_v = np.maximum((eps**4).mean(axis=0) / 3.0 - theta**2, 0.0)
    xi = np.sqrt(2.0 * kappa * var_v / theta)
    xi = np.minimum(xi, np.sqrt(2.0 * kappa * theta))   # Feller: 2 k th >= xi^2

    # leverage from the lagged return/squared-return cross moment
    lev = (eps[:-1] * sq[1:]).mean(axis=0) - eps[:-1].mean(axis=0) * sq.mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(xi > 1e-12, lev / np.maximum(xi * theta, 1e-300), 0.0)
    rho = np.clip(np.nan_to_num(rho), -0.95, 0.95)

    v_proxy = _ewma_variance(logret)
    z = eps / np.sqrt(np.maximum(v_proxy, 1e-12))
    corr = np.atleast_2d(np.corrcoef(z, rowvar=False))
    chol = np.linalg.cholesky(corr + jitter * np.eye(a))

    v0 = np.maximum(
        EWMA_LAMBDA * v_proxy[-1] + (1.0 - EWMA_LAMBDA) * eps[-1] ** 2, 1e-12)
    mu = logret.mean(axis=0) + theta / 2.0
    return HestonParams(
        mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho, v0=v0,
        corr_chol=chol, s0=prices[-1].copy(),
    )


# ---- filtered quasi-likelihood refinement (round 5) ------------------------
#
# The moment matcher above is consistent but noisy on short histories (kappa
# from an acf ratio, xi from a 4th moment). ``fit_heston_qmle`` refines
# (mu, kappa, theta, c = xi*rho) by maximizing the Gaussian quasi-likelihood
# of returns under the LEVERAGE FILTER: the latent variance is propagated by
# its conditional expectation given the observed return shock,
#
#     vhat_{t+1} = vhat_t + kappa (theta - vhat_t) + c sqrt(vhat_t) z_t,
#     z_t = (r_t - mu + vhat_t/2) / sqrt(vhat_t),
#
# i.e. E[v_{t+1} | v_t, zc_t] with the unobserved orthogonal variance shock
# integrated out (E[zv | zc] = rho zc). This is the observation-driven
# approximation standard for return-only SV estimation (the same structure as
# Heston-Nandi GARCH): it turns the latent diffusion into a GARCH-like
# recursion whose likelihood identifies mu, kappa, theta and the leverage
# slope c = xi*rho. xi alone is NOT identified by the filter (only the
# product c enters), so xi is re-derived from the conditional-kurtosis moment
# at the refined (kappa, theta) and rho = c/xi. The filter ignores the
# orthogonal dispersion of v, so it is a QUASI-likelihood; small-sample bias
# is measured and documented in tests/test_heston_recovery.py.


def _qmle_nll(params: Array, r: Array, sd: Array) -> Array:
    """Negative Gaussian quasi-log-likelihood on STANDARDIZED returns.

    ``params = (mu, kappa, theta, c)`` on the standardized scale
    (r' = r / sd, so theta' ~ 1, c' = xi*rho/sd). The Ito drift correction
    does NOT rescale with the returns: r' = (mu' - v' sd / 2) + sqrt(v') z,
    hence the ``0.5 * vp * sd`` term. Filter initialized at the sample
    variance of r' (= 1), full truncation inside the recursion.
    """
    mu, kappa, theta, c = params[0], params[1], params[2], params[3]

    def step(v, r_t):
        vp = jnp.maximum(v, 1e-8)
        resid = r_t - mu + 0.5 * vp * sd
        ll = -0.5 * (jnp.log(2.0 * jnp.pi * vp) + resid * resid / vp)
        z = resid / jnp.sqrt(vp)
        v_next = vp + kappa * (theta - vp) + c * jnp.sqrt(vp) * z
        return v_next, ll

    v0 = jnp.var(r)
    _, lls = jax.lax.scan(step, v0, r)
    return -jnp.sum(lls)


_qmle_nll_grad = jax.jit(jax.value_and_grad(_qmle_nll))


def _cpu_device():
    """CPU device for the QMLE objective, or None if unavailable.

    The (T,)-scalar filter scan is tiny; on an accelerator-backed session
    leaving it on the default backend would turn every scipy L-BFGS-B
    evaluation into a device dispatch + scalar fetch (thousands of evals).
    Committing the inputs to a CPU device keeps the whole optimization loop
    host-local on every backend.
    """
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return None


def _qmle_filter(params: np.ndarray, r: np.ndarray, sd: float):
    """(standardized residuals z_t, filter end state vhat_{T+1})."""
    mu, kappa, theta, c = params
    v = float(np.var(r))
    z = np.empty_like(r)
    for t, r_t in enumerate(r):
        vp = max(v, 1e-8)
        z[t] = (r_t - mu + 0.5 * vp * sd) / np.sqrt(vp)
        v = vp + kappa * (theta - vp) + c * np.sqrt(vp) * z[t]
    return z, max(v, 1e-8)


_LRT_95 = 3.84  # chi2_1 95% critical value — the leverage-pretest gate


def fit_heston_qmle(
    prices: np.ndarray, init: HestonParams | None = None, jitter: float = 1e-10,
) -> HestonParams:
    """Leverage-filter QMLE refinement of the moment-matched calibration.

    Per asset, maximizes the filtered Gaussian quasi-likelihood over
    (mu, kappa, theta, c = xi*rho) with scipy L-BFGS-B (jax gradients),
    started from the moment match (plus two spread starts — the likelihood
    can have a flat kappa ridge on short histories). Post-fit, xi comes from
    the conditional-kurtosis moment at the refined (kappa, theta); v0 is the
    filter END state (today's conditional variance given the whole history —
    sharper than the EWMA proxy). The cross-asset shock correlation R is
    re-estimated from filter-standardized residuals.

    Leverage pretest (round-5 review fix): the fitted c is a noisy slope, so
    before letting it drive (xi, rho) the leverage evidence is tested with a
    likelihood ratio against a c = 0 refit (LRT ~ chi2_1 under the null).
    Only when the LRT clears the 95% critical value (3.84) is xi floored at
    |c| / 0.95 to preserve the identified product xi*rho = c (Feller wins
    when the two conflict). Below the gate, xi stays at the un-floored
    moment value and rho = clip(c/xi) is SHRUNK by the evidence weight
    LRT/3.84 — so degenerate no-stochastic-vol series degrade toward
    xi ~ 0, rho ~ 0 (plain GBM) instead of pinning |rho| at 0.95 with an xi
    manufactured from leverage-slope sampling noise (measured: 1/3 of
    pure-GBM seeds before the fix, independent of n). Like any pretest
    estimator this is model selection, so it is deliberately NOT continuous
    in the data at LRT = 3.84 when the |c|/0.95 floor binds: crossing the
    gate switches xi (and hence rho = c/xi) from the moment value to the
    product-preserving floor in one step. The rho shrink weight itself
    reaches 1 at the gate; fading the xi floor in below the gate instead
    would re-manufacture xi from sub-significant leverage noise on exactly
    the pure-GBM seeds the gate exists to protect (review r5).

    Falls back to the moment match per asset when the optimizer fails to
    improve the quasi-likelihood at the moment-matched point.
    """
    from scipy.optimize import minimize

    prices = np.asarray(prices, np.float64)
    if init is None:
        init = estimate_heston(prices, jitter=jitter, method="moment")
    logret = np.diff(np.log(prices), axis=0)
    t_len, a = logret.shape
    sd = logret.std(axis=0, ddof=1)
    sd = np.maximum(sd, 1e-12)

    mu = np.array(init.mu, np.float64)
    kappa = np.array(init.kappa, np.float64)
    theta = np.array(init.theta, np.float64)
    xi = np.array(init.xi, np.float64)
    rho = np.array(init.rho, np.float64)
    v0 = np.array(init.v0, np.float64)
    z_resid = np.empty_like(logret)

    cpu = _cpu_device()

    for i in range(a):
        s = sd[i]
        r = logret[:, i] / s
        rj = jnp.asarray(r) if cpu is None else jax.device_put(r, cpu)
        vbar = float(np.var(r))

        def fun(p):
            pj = (jnp.asarray(p) if cpu is None
                  else jax.device_put(np.asarray(p), cpu))
            val, g = _qmle_nll_grad(pj, rj, float(s))
            return float(val), np.asarray(g, np.float64)

        bounds = [(None, None), (1e-3, 1.5), (1e-6, 10.0 * vbar + 1e-6),
                  (-0.9, 0.9)]
        p_mm = np.array([mu[i] / s, kappa[i], theta[i] / (s * s),
                         np.clip(xi[i] * rho[i] / s, -0.85, 0.85)])
        nll_mm = fun(p_mm)[0]
        best = None
        for k0, c0 in ((None, None), (0.10, -0.10), (0.50, 0.0)):
            p0 = p_mm.copy()
            if k0 is not None:
                p0[1], p0[3] = k0, c0
            try:
                res = minimize(fun, p0, jac=True, method="L-BFGS-B",
                               bounds=bounds)
            except Exception:
                continue
            if np.isfinite(res.fun) and (best is None or res.fun < best.fun):
                best = res
        degenerate = best is not None and (
            best.x[1] <= 1.5e-3       # kappa pinned: no reversion identified,
            or best.x[2] <= 2e-6      # theta rides an unidentified ridge
        )
        if best is None or best.fun > nll_mm + 1e-9 or degenerate:
            # keep the moment match; still need standardized residuals for R
            p_use = p_mm
        else:
            # leverage LRT: refit with c pinned to 0 (warm start); the nll is
            # a SUM, so 2*(nll_c0 - nll_free) ~ chi2_1 under the no-leverage
            # null (see docstring — measured null median ~1.1 on pure GBM)
            b0 = list(bounds)
            b0[3] = (0.0, 0.0)
            p0 = np.asarray(best.x, np.float64).copy()
            p0[3] = 0.0
            try:
                res0 = minimize(fun, p0, jac=True, method="L-BFGS-B",
                                bounds=b0)
                if np.isfinite(res0.fun) and res0.fun < best.fun:
                    # the warm-started c=0 refit slid PAST the free optimum
                    # (flat kappa ridge): the free fit is dominated, so adopt
                    # the better no-leverage fit outright (review r5) — lrt
                    # is exactly 0 by construction then
                    best = res0
                lrt = max(2.0 * (float(res0.fun) - float(best.fun)), 0.0)
            except Exception:
                lrt = 0.0                         # no evidence if refit fails
            p_use = np.asarray(best.x, np.float64)
            mu_q, kappa_q, theta_q, c_q = p_use
            mu[i] = mu_q * s
            kappa[i] = kappa_q
            theta[i] = max(theta_q * s * s, 1e-12)
            c_abs = c_q * s                       # xi*rho on the return scale
            # xi from Var(v) at the refined (kappa, theta): the larger of the
            # conditional-kurtosis moment (E[eps^4]/3 - theta^2) and the
            # lag-1 autocovariance of squared residuals (c1 = (1-k) Var(v)) —
            # both unbiased, both noisy at stationary scale; taking the max
            # counters the downward median bias each shows alone
            eps = logret[:, i] - logret[:, i].mean()
            sq = eps**2
            sqc = sq - sq.mean()
            c1 = float((sqc[:-1] * sqc[1:]).mean())
            var_v = max(float((eps**4).mean()) / 3.0 - theta[i] ** 2, 0.0)
            # the autocovariance moment c1 = (1-kappa) Var(v) only carries
            # information for kappa < 1 (AR(1) persistence phi = 1-kappa in
            # (0,1)); past that the old max(1-kappa, 1e-3) floor DIVIDED BY
            # 1e-3 and inflated var_v ~1000x whenever the likelihood rode
            # the kappa ridge above 1 (review r5: Feller-cap xi on pure GBM)
            if kappa[i] < 0.999:
                var_v = max(var_v, c1 / (1.0 - kappa[i]))
            xi_q = np.sqrt(2.0 * kappa[i] * var_v / theta[i])
            if lrt >= _LRT_95:
                # leverage confirmed: preserve the identified xi*rho = c via
                # the |c|/0.95 floor ... but Feller wins when the two
                # conflict (|c| too large to decompose): xi stays simulable,
                # rho clips, xi*rho != c
                xi_q = max(xi_q, abs(c_abs) / 0.95)
                xi_q = min(xi_q, np.sqrt(2.0 * kappa[i] * theta[i]))
                xi[i] = xi_q
                rho[i] = (float(np.clip(c_abs / xi_q, -0.95, 0.95))
                          if xi_q > 1e-12 else 0.0)
            else:
                # leverage not significant: no manufactured xi floor, and
                # rho shrunk by the evidence weight (continuous at the gate)
                xi_q = min(xi_q, np.sqrt(2.0 * kappa[i] * theta[i]))
                xi[i] = xi_q
                raw = (float(np.clip(c_abs / xi_q, -0.95, 0.95))
                       if xi_q > 1e-12 else 0.0)
                rho[i] = raw * (lrt / _LRT_95)

        # filter-standardized residuals for the cross-asset correlation +
        # today's variance state (filter end state)
        z_resid[:, i], v_end = _qmle_filter(p_use, r, s)
        if p_use is not p_mm:
            v0[i] = v_end * s * s

    corr = np.atleast_2d(np.corrcoef(z_resid, rowvar=False))
    chol = np.linalg.cholesky(corr + jitter * np.eye(a))
    return HestonParams(
        mu=mu, kappa=kappa, theta=theta, xi=xi, rho=rho,
        v0=np.maximum(v0, 1e-12), corr_chol=chol, s0=prices[-1].copy(),
    )


def _draw_shocks(key, t, n_paths: int, a: int, corr_chol_t, rho, dtype):
    """Per-step (zc, zv) shocks: zc cross-asset correlated, zv leveraged."""
    kt = jax.random.fold_in(key, t)
    k_z, k_w = jax.random.split(kt)
    zc = jax.random.normal(k_z, (n_paths, a), dtype) @ corr_chol_t
    w = jax.random.normal(k_w, (n_paths, a), dtype)
    zv = rho * zc + jnp.sqrt(1.0 - rho * rho) * w
    return zc, zv


def _heston_step(v, zc, zv, mu, kappa, theta, xi):
    """(log increment x, next variance) under full-truncation Euler."""
    vp = jnp.maximum(v, 0.0)
    sv = jnp.sqrt(vp)
    x = (mu - 0.5 * vp) + sv * zc
    v_next = v + kappa * (theta - vp) + xi * sv * zv
    return x, v_next


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "full_paths", "dtype"))
def _simulate(
    key, mu, kappa, theta, xi, rho, v0, corr_chol_t,
    n_paths: int, n_steps: int, full_paths: bool, dtype=jnp.float32,
):
    a = mu.shape[-1]

    def step(carry, t):
        v, acc = carry
        zc, zv = _draw_shocks(key, t, n_paths, a, corr_chol_t, rho, dtype)
        x, v = _heston_step(v, zc, zv, mu, kappa, theta, xi)
        acc = acc + x
        out = x if full_paths else jnp.zeros((0,), dtype)
        return (v, acc), out

    init = (jnp.broadcast_to(v0, (n_paths, a)).astype(dtype),
            jnp.zeros((n_paths, a), dtype))
    (v, acc), outs = jax.lax.scan(step, init, jnp.arange(n_steps))
    return jnp.expm1(acc), (jnp.moveaxis(outs, 0, 1) if full_paths else None)


def simulate_heston_returns(
    key: Array,
    params: HestonParams,
    n_paths: int,
    n_steps: int,
    full_paths: bool = False,
    dtype=jnp.float32,
):
    """Simulate Heston returns.

    Returns ``(terminal (n_paths, A), log_increments (n_paths, n_steps, A) |
    None)`` where terminal is the compounded simple return exp(sum x) - 1
    over the horizon — the :func:`mcport.models.garch_mc
    .simulate_garch_returns` contract under the stochastic-volatility law.
    """
    return _simulate(
        key,
        jnp.asarray(params.mu, dtype), jnp.asarray(params.kappa, dtype),
        jnp.asarray(params.theta, dtype), jnp.asarray(params.xi, dtype),
        jnp.asarray(params.rho, dtype), jnp.asarray(params.v0, dtype),
        jnp.asarray(params.corr_chol, dtype).T,
        n_paths, n_steps, full_paths, dtype,
    )


def heston_terminal_returns(
    key: Array, params: HestonParams, n_paths: int, n_steps: int,
    dtype=jnp.float32,
) -> Array:
    """(n_paths, A) terminal compounded SIMPLE returns — the tail-risk
    workhorse (plugs into the family terminal matrix: hedged_tail_risk,
    compare_tail_risk, family Greeks)."""
    term, _ = simulate_heston_returns(key, params, n_paths, n_steps, False,
                                      dtype)
    return term


@partial(jax.jit, static_argnames=("n_paths", "n_steps", "dtype"))
def _path_stats(
    key, mu, kappa, theta, xi, rho, v0, corr_chol_t, w_t,
    n_paths: int, n_steps: int, dtype, hedge_args=None,
):
    a = mu.shape[-1]
    hedged = hedge_args is not None
    if hedged:
        s0, ht, hk, hp, hq = hedge_args
        p0 = jnp.broadcast_to(jnp.asarray(s0, dtype), (n_paths, a))
    else:
        p0 = jnp.ones((n_paths, a), dtype)
    n_cand = w_t.shape[-1]

    def step(carry, t):
        v_var, p, v, peak, dd = carry
        zc, zv = _draw_shocks(key, t, n_paths, a, corr_chol_t, rho, dtype)
        x, v_var = _heston_step(v_var, zc, zv, mu, kappa, theta, xi)
        g = jnp.exp(x)                                      # (n, A) gross
        if hedged:
            from mcport.options.hedged import hedged_step_returns

            p_new = p * g
            f = 1.0 + hedged_step_returns(p, p_new, ht, hk, hp, hq) @ w_t
            p = p_new
        else:
            f = g @ w_t                                     # (n, W) w'exp(x)
        v = v * f
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        return (v_var, p, v, peak, dd), None

    init = (
        jnp.broadcast_to(v0, (n_paths, a)).astype(dtype),
        p0,
        jnp.ones((n_paths, n_cand), dtype),
        jnp.ones((n_paths, n_cand), dtype),
        jnp.zeros((n_paths, n_cand), dtype),
    )
    (_, _, v, _, dd), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    return (v - 1.0).T, dd.T


def heston_path_stats(
    key: Array,
    params: HestonParams,
    weights,
    n_paths: int,
    n_steps: int,
    dtype=jnp.float32,
    hedge_args: tuple | None = None,
) -> tuple[Array, Array]:
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of W
    candidate portfolios over Heston stochastic-volatility paths — the lax
    reference for :func:`mcport.ops.pallas_heston.pallas_heston_path_stats`
    (same model, independent stream).

    Candidates compound the per-period rebalanced wealth recursion
    ``V_{t+1} = V_t · (w'exp(x_t))`` (the reference's historical R·w
    semantics, app.py:710, applied to simulated stochastic-vol log
    increments). ``hedge_args = (s0, type_id, strike, premium, qty)``
    switches to hedged per-period settlement against the simulated price
    path ``p_{t+1} = p_t exp(x_t)``
    (:func:`mcport.options.hedged.hedged_step_returns`)."""
    w = jnp.asarray(weights, dtype)
    if w.ndim == 1:
        w = w[None, :]
    return _path_stats(
        key,
        jnp.asarray(params.mu, dtype), jnp.asarray(params.kappa, dtype),
        jnp.asarray(params.theta, dtype), jnp.asarray(params.xi, dtype),
        jnp.asarray(params.rho, dtype), jnp.asarray(params.v0, dtype),
        jnp.asarray(params.corr_chol, dtype).T,
        w.T, n_paths, n_steps, dtype, hedge_args,
    )
