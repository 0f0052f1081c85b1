"""American-exercise option valuation by Longstaff-Schwartz Monte Carlo.

The reference's option tier stops at EUROPEAN semantics: legs settle at
intrinsic value against the terminal (or per-period) price
(/root/reference/app.py:164-216 — payoff curves and period returns, no
pricing, no early exercise). Real protective puts — the reference's own
"Married Put" strategy (app.py:195-216) — are usually American-style, and
their value exceeds intrinsic settlement by the early-exercise premium.
This module adds that tier: regression-based optimal stopping (Longstaff &
Schwartz 2001) over simulated risk-neutral paths.

Device mapping
--------------
LSMC is regression inside a backward time scan — per step one (N, K) basis
matrix, a (K, K) normal-equation solve, and an (N, K) @ (K,) continuation
estimate. The N-sized matmuls dominate; the K=4 solve is trivial. The
scan carries only the (N,) cashflow vector; the price paths are simulated
once per asset (``lax.map`` over assets, so peak memory is one asset's
(T, N) path matrix, never (T, N, A)). All shapes static; exercise decisions
are ``where`` selects, not control flow.

Measure note
------------
Valuation simulates under the RISK-NEUTRAL measure (drift ``r − σ²/2`` per
step), independent per asset — an American option's value depends only on
its own underlying's marginal law, so cross-asset correlation is irrelevant
here (it matters for the PORTFOLIO tier, which consumes the resulting
exercise POLICY, not these paths). The regression basis is polynomial in
moneyness ``S/K`` (degree 3, ridge-stabilized), the Longstaff-Schwartz
choice; only in-the-money paths enter the regression (LS 2001 §2.2 — the
continuation fit only needs accuracy where the exercise decision is live).

Estimator notes
---------------
* The fitted policy is suboptimal, so plugging it back into the SAME paths
  gives a LOW-biased value (Glasserman ch. 8); the bias shrinks with N and
  basis richness. ``n_paths ≥ 2^16`` with antithetic pairing puts the bias
  well under the MC standard error at analysis scales (pinned vs a
  1000-step binomial oracle in tests/test_american.py).
* An American call on a non-dividend asset is never exercised early
  (Merton): its LSMC value must match Black-Scholes — a free closed-form
  law test, also pinned.
* The per-step regression coefficients ARE the exercise policy; they are
  returned (``AmericanPolicy``) so physical-measure engines can settle
  hedges at the fitted optimal stopping time instead of expiry.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from mcport.options.legs import LegType

__all__ = [
    "AmericanPolicy",
    "AmericanGreeks",
    "american_value",
    "american_greeks",
    "bs_european_value",
    "exercise_boundary",
    "american_hedged_terminal_returns",
    "american_hedged_tail_risk",
]

_DEGREE = 3          # polynomial basis 1, x, x², x³ in moneyness x = S/K
_RIDGE = 1e-6        # ridge scale (× N) on the normal equations


@dataclass(frozen=True)
class AmericanPolicy:
    """Fitted exercise policy + value diagnostics for one batch of options.

    ``betas[a, t]`` are the continuation-value regression coefficients of
    asset ``a`` at exercise date ``t+1`` (dates run 1..n_steps-1; expiry
    exercises at intrinsic, date 0 never exercises). ``exercise(t, s)``
    reproduces the simulated decision rule exactly.
    """

    strike: np.ndarray      # (A,)
    is_put: np.ndarray      # (A,) bool
    rate_step: float        # per-step risk-free log rate
    betas: np.ndarray       # (A, n_steps-1, K)
    x_lo: np.ndarray        # (A, n_steps-1) fitted ITM moneyness support
    x_hi: np.ndarray        # (A, n_steps-1)
    boundary: np.ndarray    # (A, n_steps-1) exercise threshold price (NaN =
    #                         the fitted rule never fires at that date)
    value: np.ndarray       # (A,) LSMC value (floored at date-0 intrinsic)
    se: np.ndarray          # (A,) MC standard error of the continuation mean
    european: np.ndarray    # (A,) Black-Scholes European value (same inputs)

    @property
    def early_premium(self) -> np.ndarray:
        """Early-exercise premium: American − European (≥ 0 up to MC error)."""
        return self.value - self.european

    def exercise(self, t: int, s: Array, asset: int) -> Array:
        """The exported rule at date ``t`` (1-indexed), in THRESHOLD form:
        a put exercises iff ``s ≤ boundary[t]``, a call iff ``s ≥ boundary``
        (never, where the boundary is NaN). The threshold is the fitted
        continuation-vs-intrinsic crossing nearest the money — identical to
        the in-simulation regression rule where the exercise decision is
        live, and strictly saner deep ITM, where a cubic fit on a handful of
        extreme paths can wiggle above intrinsic (LSMC's known edge; the
        true continuation is monotone so the exercise region is a
        half-line). Vectorized over ``s``."""
        b = self.boundary[asset, t - 1]
        s = jnp.asarray(s)
        pay = _intrinsic(s, float(self.strike[asset]),
                         bool(self.is_put[asset]))
        hit = (s <= b) if bool(self.is_put[asset]) else (s >= b)
        return (pay > 0.0) & hit & jnp.bool_(not np.isnan(b))


def _intrinsic(s: Array, strike, is_put) -> Array:
    """Intrinsic value; ``is_put`` may be a traced bool (one program serves
    both kinds, so per-asset put/call batches need no double simulation)."""
    return jnp.maximum(jnp.where(is_put, strike - s, s - strike), 0.0)


def _basis(x: Array) -> Array:
    """(N, K) polynomial design matrix in moneyness (centered at 1 for
    f32 conditioning; strikes are near-spot in hedging use)."""
    xc = x - 1.0
    return jnp.stack([jnp.ones_like(xc), xc, xc * xc, xc * xc * xc], axis=-1)


def _one_asset_value(seed_key, s0, sigma, strike, is_put, rate_step,
                     div_step, n_paths, n_steps, antithetic):
    """(value, se, betas, x_lo, x_hi) for one option; f32 throughout.

    ``value`` is the date-0 optimum max(intrinsic(s0), mean continuation);
    ``se`` is the MC error of the continuation mean (the floor is exact).
    ``betas`` (n_steps-1, K) with the per-date ITM moneyness support."""
    half = n_paths // 2 if antithetic else n_paths
    drift = rate_step - div_step - 0.5 * sigma * sigma

    def sim_step(logs, t):
        z = jax.random.normal(jax.random.fold_in(seed_key, t), (half,),
                              jnp.float32)
        if antithetic:
            z = jnp.concatenate([z, -z])
        logs = logs + drift + sigma * z
        return logs, logs

    _, log_paths = lax.scan(sim_step, jnp.zeros(n_paths, jnp.float32),
                            jnp.arange(n_steps))
    s_paths = s0 * jnp.exp(log_paths)            # (n_steps, N), dates 1..T

    disc = jnp.float32(np.exp(-rate_step))
    cash = _intrinsic(s_paths[-1], strike, is_put)

    def back_step(cash, s_t):
        pay = _intrinsic(s_t, strike, is_put)
        x = s_t / strike
        itm = (pay > 0.0).astype(jnp.float32)
        b = _basis(x)
        bw = b * itm[:, None]
        gram = bw.T @ bw + (_RIDGE * n_paths) * jnp.eye(b.shape[1],
                                                        dtype=jnp.float32)
        y = cash * disc
        beta = jnp.linalg.solve(gram, bw.T @ y)
        cont = b @ beta
        ex = (itm > 0.0) & (pay >= cont)
        has = itm.sum() > 0.0
        lo = jnp.where(has, jnp.min(jnp.where(itm > 0.0, x, jnp.inf)), 1.0)
        hi = jnp.where(has, jnp.max(jnp.where(itm > 0.0, x, -jnp.inf)), 1.0)
        return jnp.where(ex, pay, y), (beta, lo, hi)

    # dates T-1 .. 1 run backward; date 0 is the intrinsic floor below
    cash, (betas_rev, lo_rev, hi_rev) = lax.scan(back_step, cash,
                                                 s_paths[-2::-1])
    v = cash * disc
    cont0 = jnp.mean(v)
    if antithetic:
        # se over antithetic PAIR means (the independent draws)
        pm = 0.5 * (v[:half] + v[half:])
        se = jnp.std(pm, ddof=1) / jnp.sqrt(half)
    else:
        se = jnp.std(v, ddof=1) / jnp.sqrt(n_paths)
    value = jnp.maximum(cont0, _intrinsic(jnp.asarray(s0), strike, is_put))
    # betas/support for dates 1..T-1, in date order
    return value, se, betas_rev[::-1], lo_rev[::-1], hi_rev[::-1]


@functools.partial(jax.jit, static_argnames=("rate_step", "div_step",
                                             "n_paths", "n_steps",
                                             "antithetic"))
def _run_batch(base, s0j, sigj, kj, putj, rate_step, div_step, n_paths,
               n_steps, antithetic):
    """Module-level jit so repeat calls at one shape reuse the compile."""
    def one(args):
        i, s0_i, sig_i, k_i, put_i = args
        key = jax.random.fold_in(base, i)
        return _one_asset_value(key, s0_i, sig_i, k_i, put_i, rate_step,
                                div_step, n_paths, n_steps, antithetic)

    idx = jnp.arange(s0j.shape[0])
    return lax.map(one, (idx, s0j, sigj, kj, putj))


def bs_european_value(s0, sigma_step, strike, is_put, rate_step,
                      n_steps, div_step: float = 0.0) -> np.ndarray:
    """Black-Scholes European value on the same per-step inputs (vectorized).

    σ√T = sigma_step·√n_steps, discount exp(-rate_step·n_steps), forward
    s0·exp((rate−div)·n_steps) — exact for the simulated lognormal law, the
    natural early-premium baseline."""
    s0 = np.asarray(s0, np.float64)
    k = np.asarray(strike, np.float64)
    sig = np.asarray(sigma_step, np.float64) * np.sqrt(n_steps)
    df = np.exp(-rate_step * n_steps)
    fwd = s0 * np.exp((rate_step - div_step) * n_steps)
    d1 = (np.log(fwd / k) + 0.5 * sig * sig) / sig
    d2 = d1 - sig
    from math import erf

    phi = np.vectorize(lambda x: 0.5 * (1.0 + erf(x / np.sqrt(2.0))))
    call = df * (fwd * phi(d1) - k * phi(d2))
    put = call - df * (fwd - k)                  # parity
    return np.where(np.asarray(is_put, bool), put, call)


def american_value(
    seed,
    s0,
    sigma_step,
    strike,
    is_put=True,
    rate_step: float = 0.0,
    n_paths: int = 131_072,
    n_steps: int = 252,
    antithetic: bool = True,
    div_step: float = 0.0,
) -> AmericanPolicy:
    """LSMC value + fitted exercise policy for a batch of American options.

    Parameters are per-asset arrays (A,) in PER-STEP units (one simulated
    step = one analysis period, the framework convention): ``sigma_step`` is
    the per-step log-return vol, ``rate_step`` the per-step risk-free log
    rate, ``div_step`` a continuous dividend/carry yield (risk-neutral drift
    ``r − q − σ²/2``; q > 0 makes CALL early exercise optimal — Merton's
    never-early-exercise result only holds at q = 0). Exercise dates are
    every step (Bermudan → American as steps grow). Assets stream through
    ``lax.map`` so peak memory is one (T, N) path matrix; streams are
    counter-addressed per asset (fold_in), independent of the portfolio
    engines' draw streams.
    """
    s0 = np.atleast_1d(np.asarray(s0, np.float32))
    sig = np.broadcast_to(np.asarray(sigma_step, np.float32), s0.shape)
    k = np.broadcast_to(np.asarray(strike, np.float32), s0.shape)
    puts = np.broadcast_to(np.asarray(is_put, bool), s0.shape)
    if n_paths % 2 and antithetic:
        raise ValueError("antithetic pairing needs an even n_paths")
    if np.any(sig <= 0.0) or np.any(k <= 0.0) or np.any(s0 <= 0.0):
        raise ValueError("need s0 > 0, strike > 0, sigma > 0")

    base = jax.random.key(seed) if np.ndim(seed) == 0 else seed

    value, se, betas, x_lo, x_hi = _run_batch(
        base, jnp.asarray(s0), jnp.asarray(sig), jnp.asarray(k),
        jnp.asarray(puts), float(rate_step), float(div_step), n_paths,
        n_steps, antithetic)
    eur = bs_european_value(s0, sig, k, puts, rate_step, n_steps, div_step)
    betas, x_lo, x_hi = (np.asarray(betas), np.asarray(x_lo),
                         np.asarray(x_hi))
    kk = np.asarray(k, np.float64)
    pp = np.asarray(puts)
    return AmericanPolicy(
        strike=kk, is_put=pp, rate_step=float(rate_step), betas=betas,
        x_lo=x_lo, x_hi=x_hi,
        boundary=_boundaries(betas, x_lo, x_hi, kk, pp),
        value=np.asarray(value, np.float64), se=np.asarray(se, np.float64),
        european=np.asarray(eur, np.float64))


def _boundaries(betas, x_lo, x_hi, strike, is_put,
                n_grid: int = 4_096) -> np.ndarray:
    """(A, n_steps-1) threshold prices from the fitted regressions.

    Per date, evaluate intrinsic vs fitted continuation on a moneyness grid
    ((0, 1] puts / [1, 4) calls, support-clamped like the in-sim decisions)
    and take the firing grid point NEAREST THE MONEY — the boundary of the
    exercise half-line. NaN where the rule never fires (a non-dividend
    call's every date, up to regression noise)."""
    a_cnt, t_cnt, _ = betas.shape
    out = np.full((a_cnt, t_cnt), np.nan)
    for a in range(a_cnt):
        put = bool(is_put[a])
        x = np.linspace(1e-3, 1.0, n_grid) if put else np.linspace(
            1.0, 4.0, n_grid)
        pay = np.maximum(1.0 - x, 0.0) if put else np.maximum(x - 1.0, 0.0)
        xc = np.clip(x[None, :], x_lo[a][:, None], x_hi[a][:, None]) - 1.0
        design = np.stack([np.ones_like(xc), xc, xc * xc, xc**3], axis=-1)
        cont = np.einsum("tgk,tk->tg", design, betas[a])   # (T-1, G)
        fires = (pay[None, :] > 0.0) & (pay[None, :] * strike[a] >= cont)
        for t in range(t_cnt):
            idx = np.nonzero(fires[t])[0]
            if idx.size:
                out[a, t] = x[idx.max() if put else idx.min()] * strike[a]
    return out


def exercise_boundary(policy: AmericanPolicy, asset: int = 0) -> np.ndarray:
    """(n_steps-1,) exercise threshold price per date for ``asset`` (NaN
    where the fitted rule never fires at that date)."""
    return policy.boundary[asset]


# ---- policy-frozen pathwise Greeks ------------------------------------------


# folded into the base key before per-asset addressing so the Greeks paths
# can never collide with the pricing paths of the same integer seed (the
# split-vs-fold_in collision class documented in ops/quantile._CI_KEY_TAG)
_GREEKS_KEY_TAG = 0x616D6772


@dataclass(frozen=True)
class AmericanGreeks:
    """Pathwise sensitivities of a batch of American options at a FIXED
    (policy-frozen) exercise rule. ``value`` is the policy-replay value on
    the fresh Greeks paths (a cross-check against ``AmericanPolicy.value``);
    ``delta``/``vega`` differentiate it w.r.t. spot and PER-STEP vol."""

    value: np.ndarray   # (A,) discounted stopped payoff mean, fresh paths
    delta: np.ndarray   # (A,) dV/dS0
    vega: np.ndarray    # (A,) dV/dsigma_step (per-step vol units)
    se: np.ndarray      # (A,) MC standard error of ``value``


def _stopped_value(key, s0, sigma, thr, strike, is_put, rate_step, div_step,
                   n_paths, n_steps, antithetic):
    """Discounted payoff mean of the FIXED threshold policy ``thr``
    ((n_steps-1,) prices, ±inf = never) on fresh risk-neutral paths.
    Differentiable in (s0, sigma): the stop decision is a boolean
    ``where`` mask (no gradient path), and at the fitted boundary the put's
    payoff is continuous across the exercise indicator (value matching), so
    the pathwise derivative is the consistent policy-frozen estimator
    (envelope theorem: the optimal policy's first-order value change under a
    spot/vol bump is zero, Glasserman ch. 7)."""
    half = n_paths // 2 if antithetic else n_paths
    drift = rate_step - div_step - 0.5 * sigma * sigma
    disc = jnp.exp(-rate_step * jnp.arange(1, n_steps + 1,
                                           dtype=jnp.float32))   # (T,)

    def step(carry, t):
        logs, locked, done = carry
        z = jax.random.normal(jax.random.fold_in(key, t), (half,),
                              jnp.float32)
        if antithetic:
            z = jnp.concatenate([z, -z])
        logs = logs + drift + sigma * z
        s = s0 * jnp.exp(logs)
        hit = jnp.where(is_put, s <= thr[t - 1], s >= thr[t - 1])
        newly = hit & ~done
        locked = jnp.where(newly, _intrinsic(s, strike, is_put) * disc[t - 1],
                           locked)
        return (logs, locked, done | newly), None

    init = (jnp.zeros(n_paths, jnp.float32), jnp.zeros(n_paths, jnp.float32),
            jnp.zeros(n_paths, bool))
    (logs, locked, done), _ = lax.scan(step, init,
                                       jnp.arange(1, n_steps))
    # expiry: no threshold — settle unexercised paths at intrinsic
    z_t = jax.random.normal(jax.random.fold_in(key, n_steps), (half,),
                            jnp.float32)
    if antithetic:
        z_t = jnp.concatenate([z_t, -z_t])
    s_t = s0 * jnp.exp(logs + drift + sigma * z_t)
    pay = jnp.where(done, locked,
                    _intrinsic(s_t, strike, is_put) * disc[-1])
    if antithetic:
        pm = 0.5 * (pay[:half] + pay[half:])
        se = jnp.std(pm, ddof=1) / jnp.sqrt(half)
    else:
        se = jnp.std(pay, ddof=1) / jnp.sqrt(n_paths)
    return jnp.mean(pay), se


@functools.partial(jax.jit, static_argnames=("rate_step", "div_step",
                                             "n_paths", "n_steps",
                                             "antithetic"))
def _greeks_batch(base, s0j, sigj, thrj, kj, putj, rate_step, div_step,
                  n_paths, n_steps, antithetic):
    def one(args):
        i, s0_i, sig_i, thr_i, k_i, put_i = args
        key = jax.random.fold_in(base, i)

        def val(s0v, sigv):
            return _stopped_value(key, s0v, sigv, thr_i, k_i, put_i,
                                  rate_step, div_step, n_paths, n_steps,
                                  antithetic)

        (v, se), (d, vg) = jax.value_and_grad(val, argnums=(0, 1),
                                              has_aux=True)(s0_i, sig_i)
        return v, d, vg, se

    idx = jnp.arange(s0j.shape[0])
    return lax.map(one, (idx, s0j, sigj, thrj, kj, putj))


def american_greeks(
    policy: AmericanPolicy,
    seed,
    s0,
    sigma_step,
    div_step: float = 0.0,
    n_paths: int = 65_536,
    antithetic: bool = True,
) -> AmericanGreeks:
    """Delta and vega of American options under the FITTED exercise policy.

    Pathwise AD with the policy frozen in threshold form: fresh risk-neutral
    paths (independent key domain, so no collision with the pricing streams)
    stop at ``policy.boundary`` and the discounted stopped payoff is
    differentiated w.r.t. ``s0`` and ``sigma_step`` by reverse-mode AD
    through the whole simulation. Consistent for the American delta/vega by
    the envelope theorem (the value is first-order stationary in the policy
    at the optimum); gamma needs the LR/pathwise mixed estimator and lives in
    the hedged-book tier (:func:`mcport.engine.greeks.hedged_lr_gamma`).

    ``n_steps`` is taken from the policy (``boundary.shape[1] + 1``);
    ``s0``/``sigma_step`` may differ from the fitting inputs (bump-and-refit
    is NOT needed — that is the point of the frozen-policy estimator).
    """
    s0 = np.atleast_1d(np.asarray(s0, np.float32))
    sig = np.broadcast_to(np.asarray(sigma_step, np.float32), s0.shape)
    if s0.shape[0] != policy.strike.shape[0]:
        raise ValueError("s0 batch does not match the policy's asset batch")
    if n_paths % 2 and antithetic:
        raise ValueError("antithetic pairing needs an even n_paths")
    n_steps = policy.boundary.shape[1] + 1
    never = np.where(policy.is_put[:, None], -np.inf, np.inf)
    thr = np.where(np.isnan(policy.boundary), never,
                   policy.boundary).astype(np.float32)       # (A, T-1)

    base = jax.random.fold_in(
        jax.random.key(seed) if np.ndim(seed) == 0 else seed,
        _GREEKS_KEY_TAG)
    v, d, vg, se = _greeks_batch(
        base, jnp.asarray(s0), jnp.asarray(sig), jnp.asarray(thr),
        jnp.asarray(policy.strike, jnp.float32), jnp.asarray(policy.is_put),
        float(policy.rate_step), float(div_step), n_paths, n_steps,
        antithetic)
    return AmericanGreeks(value=np.asarray(v, np.float64),
                          delta=np.asarray(d, np.float64),
                          vega=np.asarray(vg, np.float64),
                          se=np.asarray(se, np.float64))


# ---- physical-measure settlement of American-style hedges ------------------


def _leg_boundaries(spec, s0, sigma_step, rate_step, n_steps, seed,
                    policy_paths):
    """(A, L, n_steps) per-leg exercise thresholds (+/-inf = never fires).

    Fits one LSMC policy per OPTION leg (types 2-5) at the leg's own strike
    by one batched :func:`american_value` call; asset/futures legs and qty-0
    padding get never-firing thresholds. The last date never fires early —
    expiry settles at intrinsic in the terminal composition itself. NaNs are
    resolved to the never-firing infinity of the leg's kind so the scan's
    comparisons need no NaN handling.
    """
    type_id, strike, _, qty = (np.asarray(spec.type_id), np.asarray(
        spec.strike), np.asarray(spec.premium), np.asarray(spec.qty))
    a_cnt, l_cnt = type_id.shape
    is_put_leg = (type_id == LegType.BUY_PUT) | (type_id == LegType.SELL_PUT)
    is_call_leg = ((type_id == LegType.BUY_CALL)
                   | (type_id == LegType.SELL_CALL))
    live = (is_put_leg | is_call_leg) & (qty != 0.0) & (strike > 0.0)

    never = np.where(is_put_leg, -np.inf, np.inf)          # (A, L)
    bnd = np.broadcast_to(never[:, :, None], (a_cnt, l_cnt, n_steps)).copy()
    ai, li = np.nonzero(live)
    if ai.size:
        pol = american_value(
            seed, np.asarray(s0, np.float64)[ai],
            np.asarray(sigma_step, np.float64)[ai], strike[ai, li],
            is_put=is_put_leg[ai, li], rate_step=rate_step,
            n_paths=policy_paths, n_steps=n_steps)
        b = pol.boundary                                    # (n_live, T-1)
        nan = np.isnan(b)
        b = np.where(nan, np.where(is_put_leg[ai, li][:, None], -np.inf,
                                   np.inf), b)
        bnd[ai, li, :-1] = b
    return bnd


def american_hedged_terminal_returns(
    key: Array,
    s0,
    mean_step,
    chol_step,
    spec_arrays,
    boundaries,
    rate_step: float,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
) -> tuple[Array, Array]:
    """(american, european) hedged simple returns, both (N, A), SAME paths.

    Physical-measure composition of :func:`hedged.hedged_terminal_returns`
    with early exercise: paths evolve under the ESTIMATED law (``mean_step``/
    ``chol_step``, the portfolio engines' measure), and an option leg whose
    per-date threshold fires (put: S_t ≤ b, call: S_t ≥ b — the counterparty
    exercises SHORT legs at the same thresholds, the conservative book) locks
    intrinsic at that date and accrues it risk-free to the horizon:
    ``payoff_T = intrinsic(S_t) · exp(rate_step · (T − t))``. Unexercised legs
    settle at expiry intrinsic — so with never-firing thresholds the American
    column equals the European one BITWISE (pinned in tests). The European
    column reuses the identical paths, making the pair a zero-variance
    comparison of settlement styles.
    """
    type_id, strike, premium, qty = spec_arrays
    dtype = jnp.float32
    s0 = jnp.asarray(s0, dtype)
    m = jnp.asarray(mean_step, dtype)
    lt = jnp.asarray(chol_step, dtype).T
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    k = jnp.asarray(strike, dtype)                          # (A, L)
    bnd = jnp.asarray(boundaries, dtype)                    # (A, L, T)
    is_put_leg = ((type_id == LegType.BUY_PUT)
                  | (type_id == LegType.SELL_PUT))          # (A, L)
    growth = jnp.exp(rate_step * jnp.arange(n_steps, 0, -1,
                                            dtype=dtype))   # (T,) t=1..T

    def step(carry, t):
        logs, locked, done = carry
        zk = jax.random.fold_in(key, t)
        z = jax.random.normal(zk, (half, a), dtype)
        if antithetic:
            z = jnp.concatenate([z, -z], axis=0)
        logs = logs + m + z @ lt
        s = (s0 * jnp.exp(logs))[:, :, None]                # (N, A, 1)
        b_t = bnd[:, :, t - 1]                              # (A, L)
        hit = jnp.where(is_put_leg, s <= b_t, s >= b_t)
        iv = jnp.maximum(jnp.where(is_put_leg, k - s, s - k), 0.0)
        newly = hit & ~done
        locked = jnp.where(newly, iv * growth[t - 1], locked)
        return (logs, locked, done | newly), None

    init = (jnp.zeros((n_paths, a), dtype),
            jnp.zeros((n_paths,) + k.shape, dtype),
            jnp.zeros((n_paths,) + k.shape, bool))
    (logs, locked, done), _ = lax.scan(step, init,
                                       jnp.arange(1, n_steps + 1))

    s_t = (s0 * jnp.exp(logs))[:, :, None]                  # (N, A, 1)
    final_iv = jnp.maximum(jnp.where(is_put_leg, k - s_t, s_t - k), 0.0)

    def settle(iv):
        up = s_t - s0[:, None]
        branches = [up, -up, iv - premium, premium - iv, iv - premium,
                    premium - iv, -up]
        numer = jnp.select([type_id == t for t in range(7)], branches, 0.0)
        safe = jnp.where(s0 == 0.0, 1.0, s0)[:, None]
        return jnp.sum(jnp.asarray(qty, dtype) * jnp.where(
            s0[:, None] == 0.0, 0.0, numer / safe), axis=-1)

    return settle(jnp.where(done, locked, final_iv)), settle(final_iv)


def american_hedged_tail_risk(
    params,
    weights,
    spec,
    rate_step: float,
    alpha: float = 0.95,
    n_paths: int = 131_072,
    n_steps: int = 252,
    seed: int = 0,
    antithetic: bool = False,
    policy_paths: int = 65_536,
) -> dict:
    """Tail risk of an American-settled hedged portfolio vs the European
    settlement of the SAME simulated paths.

    ``params`` is :class:`mcport.models.gbm.GBMParams` (the estimated
    physical law), ``spec`` a :class:`mcport.options.hedged.HedgeSpec`.
    Per-leg exercise policies are fitted risk-neutrally at ``rate_step``
    (one batched LSMC call over the option legs, independent streams), then
    applied pathwise. Returns both settlements' mean/VaR/CVaR plus the
    early-exercise frequency per hedged asset.
    """
    from mcport.engine.cvar_opt import exact_tail_metrics

    sigma_step = np.sqrt(np.einsum("ij,ij->i", np.asarray(params.chol_step),
                                   np.asarray(params.chol_step)))
    bnd = _leg_boundaries(spec, params.s0, sigma_step, rate_step, n_steps,
                          seed + 1, policy_paths)
    w = jnp.asarray(weights, jnp.float32)

    @functools.partial(jax.jit, static_argnames=("np_", "ns", "anti"))
    def run(key, bndj, np_, ns, anti):
        am, eu = american_hedged_terminal_returns(
            key, params.s0, params.mean_step, params.chol_step,
            spec.arrays, bndj, rate_step, np_, ns, antithetic=anti)
        out = {}
        for tag, r in (("american", am), ("european", eu)):
            var, cvar = exact_tail_metrics(r, w, alpha)
            out[tag] = {"mean": (r @ w).mean(), "var": var, "cvar": cvar}
        return out, (am != eu).mean(axis=0)

    out, ex_freq = run(jax.random.key(seed), jnp.asarray(bnd), n_paths,
                       n_steps, antithetic)
    res = {tag: {k2: float(v2) for k2, v2 in d.items()}
           for tag, d in out.items()}
    res["alpha"] = alpha
    res["exercise_frequency"] = np.asarray(ex_freq, np.float64)
    return res
