"""ARIMA(1,1,1) — JAX-native fit + forecast.

The reference calls ``statsmodels.tsa.arima.model.ARIMA(returns, order=(1,1,1))``
(app.py:343-345). statsmodels is not in this environment, so mcport implements the
model directly: difference once, fit ARMA(1,1) without constant (statsmodels'
default for d >= 1), with two estimators:

- ``method="mle"`` (default) — **exact maximum likelihood** via the state-space
  (Kalman) filter with exact stationary initialization and the innovation
  variance concentrated out: the same estimator family as statsmodels' default
  (VERDICT r1 item 8). The filter runs as a ``lax.scan``; correctness is pinned
  against a dense multivariate-normal log-likelihood in tests.
- ``method="css"`` — conditional sum of squares (the round-1 estimator), kept as
  the cheap option; CSS-vs-MLE drift on the fixture series is quantified in
  tests/test_forecast.py.

Gradients come from ``jax.grad``; the 2-parameter optimization uses scipy
L-BFGS-B on host (the fit is a few-hundred-point series; forecast-tier work, not
the device hot path).

Forecasts integrate back to the undifferenced scale, matching
``ARIMA(...).fit().forecast(steps=h)`` semantics used at app.py:345,353.

State-space form (Harvey): alpha_t = (y_t, theta*eps_t), T = [[phi, 1], [0, 0]],
R = (1, theta), Z = (1, 0); exact initialization from the stationary solution
P0 = [[(1 + 2*phi*theta + theta^2)/(1 - phi^2), theta], [theta, theta^2]].
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["Arima111Fit", "fit_arima_111", "forecast_arima", "kalman_loglik_arma11"]


@dataclass(frozen=True)
class Arima111Fit:
    phi: float        # AR(1) coefficient on the differenced series
    theta: float      # MA(1) coefficient
    sigma2: float     # innovation variance (CSS or concentrated-MLE estimate)
    last_y: float     # last differenced observation
    last_eps: float   # last fitted innovation
    last_level: float # last undifferenced observation (for integration)
    method: str = "css"
    loglik: float | None = None   # exact log-likelihood (mle only)
    state_a1: float | None = None # one-step state prediction E[alpha_{T+1}] (mle)
    state_a2: float | None = None


@partial(jax.jit, static_argnames=())
def _css_loss(params: Array, y: Array) -> Array:
    """Conditional SSR of ARMA(1,1): eps_t = y_t - phi y_{t-1} - theta eps_{t-1}."""
    phi, theta = params[0], params[1]

    def step(eps_prev, inp):
        y_t, y_prev = inp
        eps = y_t - phi * y_prev - theta * eps_prev
        return eps, eps

    _, eps = jax.lax.scan(step, jnp.zeros((), y.dtype), (y[1:], y[:-1]))
    return jnp.sum(eps**2)


_css_grad = jax.jit(jax.value_and_grad(_css_loss))


@jax.jit
def _kalman_filter_arma11(params: Array, y: Array):
    """Exact Kalman filter for ARMA(1,1) with unit innovation variance.

    Returns (ssq = sum v^2/F, sum_logF, a_next (2,)) — everything needed for the
    concentrated exact log-likelihood and the one-step state prediction.
    """
    phi, theta = params[0], params[1]
    one = jnp.ones((), y.dtype)
    # exact stationary initialization: P0 solves P = T P T' + R R'
    p11 = (one + 2 * phi * theta + theta**2) / (one - phi**2)
    P0 = jnp.array([[p11, theta], [theta, theta**2]], y.dtype)
    a0 = jnp.zeros((2,), y.dtype)
    T = jnp.array([[0.0, 1.0], [0.0, 0.0]], y.dtype).at[0, 0].set(phi)
    RRt = jnp.stack([
        jnp.stack([jnp.ones((), y.dtype), theta]),
        jnp.stack([theta, theta**2]),
    ])

    def step(carry, y_t):
        a, P = carry
        v = y_t - a[0]                      # Z = (1, 0), no measurement noise
        F = P[0, 0]
        K = (T @ P[:, 0]) / F               # Kalman gain (2,)
        a_next = T @ a + K * v
        P_next = T @ P @ T.T - jnp.outer(K, K) * F + RRt
        # keep P symmetric against drift
        P_next = 0.5 * (P_next + P_next.T)
        return (a_next, P_next), (v * v / F, jnp.log(F))

    (a_next, _), (vvF, logF) = jax.lax.scan(step, (a0, P0), y)
    return vvF.sum(), logF.sum(), a_next


@jax.jit
def _mle_neg_loglik(params: Array, y: Array) -> Array:
    """Concentrated exact negative log-likelihood (sigma^2 profiled out):
    -2 logL = n log(ssq/n) + sum log F + n (1 + log 2 pi)."""
    ssq, sum_logF, _ = _kalman_filter_arma11(params, y)
    n = y.shape[0]
    return 0.5 * (n * jnp.log(ssq / n) + sum_logF + n * (1.0 + jnp.log(2.0 * jnp.pi)))


_mle_grad = jax.jit(jax.value_and_grad(_mle_neg_loglik))


def kalman_loglik_arma11(phi: float, theta: float, sigma2: float, y: np.ndarray) -> float:
    """Exact ARMA(1,1) log-likelihood at given parameters (test/diagnostic API)."""
    yj = jnp.asarray(y, jnp.float64)
    ssq, sum_logF, _ = _kalman_filter_arma11(jnp.asarray([phi, theta], jnp.float64), yj)
    n = y.shape[0]
    return float(
        -0.5 * (n * np.log(2 * np.pi * sigma2) + sum_logF + ssq / sigma2)
    )


_STARTS = ([0.0, 0.0], [0.3, -0.3], [-0.3, 0.3], [0.7, 0.2])
_BOUNDS = [(-0.999, 0.999), (-0.999, 0.999)]


def fit_arima_111(series: np.ndarray, method: str = "mle") -> Arima111Fit:
    """Fit ARIMA(1,1,1) to a 1-D series (the reference passes *returns*).

    ``method="mle"`` (default) is exact state-space maximum likelihood —
    statsmodels' default estimator family; ``method="css"`` is conditional sum
    of squares (cheaper, slightly different estimates near unit roots).
    """
    from scipy.optimize import minimize

    if method not in ("mle", "css"):
        raise ValueError(f"unknown ARIMA fit method {method!r}")
    x = np.asarray(series, np.float64)
    if x.size < 5:
        raise ValueError("series too short for ARIMA(1,1,1)")
    y = np.diff(x)
    yj = jnp.asarray(y)
    grad_fn = _mle_grad if method == "mle" else _css_grad

    def fun(p):
        v, g = grad_fn(jnp.asarray(p), yj)
        return float(v), np.asarray(g, np.float64)

    best = None
    for p0 in _STARTS:
        res = minimize(fun, np.asarray(p0), jac=True, method="L-BFGS-B",
                       bounds=_BOUNDS)
        if best is None or res.fun < best.fun:
            best = res
    phi, theta = float(best.x[0]), float(best.x[1])

    # innovation pass for forecasting state (CSS recursion; also used to report
    # a comparable last_eps for the mle fit)
    eps = 0.0
    for t in range(1, y.size):
        eps = y[t] - phi * y[t - 1] - theta * eps

    if method == "mle":
        ssq, _, a_next = _kalman_filter_arma11(jnp.asarray([phi, theta]), yj)
        sigma2 = float(ssq) / y.size
        return Arima111Fit(
            phi=phi, theta=theta, sigma2=sigma2,
            last_y=float(y[-1]), last_eps=float(eps), last_level=float(x[-1]),
            method="mle", loglik=-float(best.fun),
            state_a1=float(a_next[0]), state_a2=float(a_next[1]),
        )
    n_eff = max(y.size - 1, 1)
    return Arima111Fit(
        phi=phi, theta=theta, sigma2=float(best.fun) / n_eff,
        last_y=float(y[-1]), last_eps=float(eps), last_level=float(x[-1]),
        method="css",
    )


def forecast_arima(fit: Arima111Fit, steps: int) -> np.ndarray:
    """h-step forecast on the original (undifferenced) scale.

    CSS fits use the conditional recursion dy_1 = phi*y_T + theta*eps_T,
    dy_k = phi*dy_{k-1}. MLE fits forecast from the exact one-step state
    prediction alpha_{T+1} = (a1, a2): dy_1 = a1, dy_2 = phi*a1 + a2, then
    dy_k = phi*dy_{k-1} — the statsmodels ``.forecast(steps)`` semantics the
    reference consumes (app.py:345). Levels integrate cumulatively from the
    last observation.
    """
    dy = np.empty(steps)
    if fit.method == "mle" and fit.state_a1 is not None:
        prev, carry = fit.state_a1, fit.state_a2
    else:
        prev, carry = fit.phi * fit.last_y + fit.theta * fit.last_eps, 0.0
    for k in range(steps):
        dy[k] = prev
        prev = fit.phi * prev + carry
        carry = 0.0
    return fit.last_level + np.cumsum(dy)
