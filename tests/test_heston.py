"""Heston stochastic-volatility family: estimation, lax reference, and
engine/API wiring.

The seventh model family (see mcport/models/heston.py): per-asset CIR
variance with leverage, cross-asset correlated return shocks, full-truncation
Euler. Identity oracle and tolerances follow test_path_stats_models.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.models.heston import (
    HestonParams,
    estimate_heston,
    heston_path_stats,
    heston_terminal_returns,
    simulate_heston_returns,
)
from mcport.options import HedgeSpec, LegType, Legs

A = 2
NAMES = ["A0", "A1"]
PARAMS = HestonParams(
    mu=np.array([8e-4, 1.2e-3]),
    kappa=np.array([0.10, 0.20]),
    theta=np.array([4e-4, 9e-4]),
    xi=np.array([2.5e-3, 4e-3]),       # well inside Feller (2 k th >= xi^2)
    rho=np.array([-0.6, -0.3]),
    v0=np.array([4e-4, 9e-4]),
    corr_chol=np.linalg.cholesky(np.array([[1.0, 0.6], [0.6, 1.0]])),
    s0=np.array([100.0, 50.0]),
)
W = np.array([[0.5, 0.5], [0.2, 0.8], [1.0, 0.0]], np.float32)
IDENTITY = HedgeSpec.build({}, NAMES)
IDENT_ARGS = (np.ones(A, np.float32), *IDENTITY.arrays)


def _frozen_vol(mu, theta):
    """xi = 0, v0 = theta: variance frozen at theta → exact GBM reduction."""
    a = len(mu)
    return HestonParams(
        mu=np.asarray(mu, np.float64), kappa=np.full(a, 0.5),
        theta=np.asarray(theta, np.float64), xi=np.zeros(a),
        rho=np.zeros(a), v0=np.asarray(theta, np.float64),
        corr_chol=np.eye(a), s0=np.ones(a),
    )


def _protective_put(s0):
    return HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(A)}, NAMES)


# ---- estimation -------------------------------------------------------------


def _np_simulate_heston_1d(rng, mu, kappa, theta, xi, rho, v0, t_len):
    """Plain-numpy single-asset simulator — the estimator's ground truth."""
    r = np.empty(t_len)
    v = v0
    for t in range(t_len):
        z = rng.standard_normal()
        w = rng.standard_normal()
        zv = rho * z + np.sqrt(1.0 - rho * rho) * w
        vp = max(v, 0.0)
        r[t] = (mu - 0.5 * vp) + np.sqrt(vp) * z
        v = v + kappa * (theta - vp) + xi * np.sqrt(vp) * zv
    return r


def test_estimator_recovers_parameters():
    rng = np.random.default_rng(7)
    mu, kappa, theta, xi, rho = 5e-4, 0.15, 6e-4, 3e-3, -0.6
    r = _np_simulate_heston_1d(rng, mu, kappa, theta, xi, rho, theta, 60_000)
    prices = 100.0 * np.exp(np.concatenate([[0.0], np.cumsum(r)]))
    p = estimate_heston(prices[:, None])
    # theta is a plain variance — tight; kappa/xi/rho are moment estimates of
    # a latent process — order-of-magnitude + sign
    np.testing.assert_allclose(p.theta[0], theta, rtol=0.10)
    np.testing.assert_allclose(p.mu[0], mu, atol=3e-4)
    assert 0.3 * kappa < p.kappa[0] < 3.0 * kappa
    assert 0.3 * xi < p.xi[0] < 3.0 * xi
    assert p.rho[0] < -0.15                       # leverage sign recovered
    assert abs(p.v0[0] - theta) < 5.0 * theta     # state near the long-run mean


def test_estimator_degenerate_and_validation():
    rng = np.random.default_rng(1)
    # constant-vol Gaussian returns: no excess kurtosis → xi collapses to ~0
    r = rng.standard_normal((20_000, 1)) * 0.02
    prices = 100.0 * np.exp(np.cumsum(np.vstack([[0.0], r]), axis=0))
    p = estimate_heston(prices)
    assert p.xi[0] < 0.3 * np.sqrt(2.0 * p.kappa[0] * p.theta[0])
    assert np.all(np.isfinite(p.corr_chol))
    with pytest.raises(ValueError, match="T>=20"):
        estimate_heston(np.ones((5, 2)))


def test_estimator_multiasset_correlation_and_shapes(fixtures_dir):
    from mcport.config import DataConfig
    from mcport.data.pipeline import load_universe

    data = load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    p = estimate_heston(data.prices)
    assert p.n_assets == 2
    for arr in (p.mu, p.kappa, p.theta, p.xi, p.rho, p.v0, p.s0):
        assert arr.shape == (2,) and np.isfinite(arr).all()
    # BTC/ETH shock correlation is strongly positive
    r = p.corr_chol @ p.corr_chol.T
    assert 0.3 < r[0, 1] < 1.0
    # Feller cap honored
    assert np.all(p.xi**2 <= 2.0 * p.kappa * p.theta + 1e-12)


# ---- lax reference ----------------------------------------------------------


def test_lax_zero_variance_closed_form():
    p = _frozen_vol([0.01, -0.005], [0.0, 0.0])
    term, _ = simulate_heston_returns(jax.random.key(0), p, 64, 6)
    term = np.asarray(term)
    np.testing.assert_allclose(term[:, 0], np.exp(0.06) - 1, rtol=1e-5)
    np.testing.assert_allclose(term[:, 1], np.exp(-0.03) - 1, rtol=1e-5)


def test_lax_frozen_vol_matches_gbm_law():
    """xi = 0, v0 = theta: terminal log returns are N(n(mu - th/2), n th)."""
    mu, theta = np.array([1e-3, 5e-4]), np.array([4e-4, 8e-4])
    p = _frozen_vol(mu, theta)
    n, steps = 40_000, 32
    term = np.asarray(heston_terminal_returns(jax.random.key(1), p, n, steps),
                      np.float64)
    logt = np.log1p(term)
    want_m = steps * (mu - theta / 2.0)
    want_s = np.sqrt(steps * theta)
    se = want_s / np.sqrt(n)
    assert np.all(np.abs(logt.mean(0) - want_m) < 6 * se)
    np.testing.assert_allclose(logt.std(0, ddof=1), want_s, rtol=0.05)


def test_lax_leverage_skews_terminal_left():
    """rho < 0 (crashes raise vol) produces negative skew vs rho = 0."""
    base = dataclasses.replace(
        PARAMS, xi=np.array([1.8e-3, 2.4e-3]), corr_chol=np.eye(A))
    neg = dataclasses.replace(base, rho=np.array([-0.9, -0.9]))
    zer = dataclasses.replace(base, rho=np.array([0.0, 0.0]))
    n, steps = 65_536, 64
    t_neg = np.asarray(heston_terminal_returns(jax.random.key(2), neg, n,
                                               steps), np.float64)
    t_zer = np.asarray(heston_terminal_returns(jax.random.key(2), zer, n,
                                               steps), np.float64)

    def skew(x):
        c = x - x.mean(0)
        return (c**3).mean(0) / (c**2).mean(0) ** 1.5

    assert np.all(skew(np.log1p(t_neg)) < skew(np.log1p(t_zer)) - 0.05)
    assert np.all(skew(np.log1p(t_neg)) < 0)


def test_lax_path_stats_shapes_and_hedged_identity():
    term, dd = heston_path_stats(jax.random.key(1), PARAMS, W[0], 1024, 13)
    assert term.shape == (1, 1024) and dd.shape == (1, 1024)
    d = np.asarray(dd)
    assert (d <= 0).all() and (d >= -1).all()
    assert (np.asarray(term) >= d - 1e-6).all()
    t0, d0 = heston_path_stats(jax.random.key(2), PARAMS, W, 512, 13)
    t1, d1 = heston_path_stats(jax.random.key(2), PARAMS, W, 512, 13,
                               hedge_args=IDENT_ARGS)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), atol=3e-6)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=3e-6)


def test_lax_terminal_equals_compounded_paths():
    term, paths = simulate_heston_returns(jax.random.key(3), PARAMS, 256, 13,
                                          full_paths=True)
    np.testing.assert_allclose(np.asarray(term),
                               np.expm1(np.asarray(paths).sum(axis=1)),
                               rtol=2e-5, atol=2e-6)


def test_lax_hedged_identity_and_put_dominance():
    tk, dk = heston_path_stats(jax.random.key(5), PARAMS, W, 512, 13)
    th, dh = heston_path_stats(jax.random.key(5), PARAMS, W, 512, 13,
                               hedge_args=IDENT_ARGS)
    np.testing.assert_allclose(np.asarray(th), np.asarray(tk), atol=3e-6)
    np.testing.assert_allclose(np.asarray(dh), np.asarray(dk), atol=3e-6)
    s0 = np.array([100.0, 50.0], np.float32)
    prot = _protective_put(s0)
    tr, dr = heston_path_stats(jax.random.key(7), PARAMS, W, 512, 13,
                               hedge_args=(s0, *IDENTITY.arrays))
    tp, dp = heston_path_stats(jax.random.key(7), PARAMS, W, 512, 13,
                               hedge_args=(s0, *prot.arrays))
    assert (np.asarray(tp) >= np.asarray(tr) - 1e-6).all()
    assert np.asarray(dp).mean() >= np.asarray(dr).mean()


# ---- engine / API / frontier wiring (the full family matrix) ----------------


def test_engine_resumable_and_family_frontier(tmp_path):
    """The seventh family rides the whole path tier: one-shot engine
    determinism, resumable bit-exact split (digest-bound), family frontier
    candidate-chunk equality, hedged settlement with s0 auto-derived from
    the fitted spot prices."""
    from mcport.config import GBMConfig
    from mcport.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport.engine.path_risk import (
        load_path_risk_checkpoint, run_heston_path_risk,
        run_resumable_path_risk,
    )

    w = np.array([0.5, 0.5])
    c = GBMConfig(n_paths=4096, path_block=1024, n_steps=8, use_pallas=False)
    r = run_heston_path_risk(PARAMS, w, c)
    assert r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert r == run_heston_path_risk(PARAMS, w, c)

    # hedged settlement: identity legs ~= the unhedged rebalanced recursion
    hid = run_heston_path_risk(PARAMS, w, c, hedge=IDENTITY)
    assert abs(hid.port_mean - r.port_mean) < 5e-3
    assert abs(hid.dd_median - r.dd_median) < 5e-3
    hp = run_heston_path_risk(PARAMS, w, c, hedge=_protective_put(PARAMS.s0))
    assert hp.dd_mean > r.dd_mean        # puts cut drawdowns

    # resumable driver: equals the one-shot engine, split is bit-exact
    full, ck_full = run_resumable_path_risk("heston", PARAMS, w, c)
    assert ck_full.done and full == r
    part, ck1 = run_resumable_path_risk("heston", PARAMS, w, c, max_blocks=2)
    assert not ck1.done and part.n_paths == 2048
    path = tmp_path / "heston.npz"
    ck1.save(path)
    resumed, ck2 = run_resumable_path_risk(
        "heston", PARAMS, w, c, checkpoint=load_path_risk_checkpoint(path))
    assert ck2.done and resumed == full
    # digest binds to the parameters: a different xi is a different run
    other = dataclasses.replace(PARAMS, xi=PARAMS.xi * 2.0)
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("heston", other, w, c, checkpoint=ck1)

    fr = family_drawdown_frontier_search(
        jax.random.key(0), "heston", PARAMS, dd_budget=0.8, n_candidates=64,
        n_paths=512, n_steps=8)
    assert fr.opt_idx >= 0
    fr2 = family_drawdown_frontier_search(
        jax.random.key(0), "heston", PARAMS, dd_budget=0.8, n_candidates=64,
        n_paths=512, n_steps=8, w_block=32)
    np.testing.assert_array_equal(fr.ret, fr2.ret)


def test_api_tier_path_hedged_and_greeks(fixtures_dir):
    """model="heston" through the public API: path_tail_risk,
    hedged_tail_risk, and the family Greeks tier (Euler homogeneity of the
    weight gradient holds under the stochastic-vol terminal law)."""
    from mcport.api import hedged_tail_risk, path_tail_risk, sensitivities
    from mcport.config import Config, DataConfig, GBMConfig
    from mcport.data.pipeline import load_universe

    data = load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    cfg = Config(gbm=GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                               use_pallas=False, seed=2))
    out = path_tail_risk(data, None, cfg, model="heston")
    assert out["model"] == "heston" and out["cvar"] <= out["var"]
    assert -1.0 <= out["dd_p95"] <= out["dd_median"] <= 0.0

    legs = {data.names[0]: [("BUY_ASSET", 0.0, 0.0, 1.0),
                            ("BUY_PUT", float(data.prices[-1, 0]) * 0.95,
                             0.0, 1.0)]}
    h = hedged_tail_risk(data, None, cfg, legs, model="heston")
    assert h["model"] == "heston" and h["cvar"] <= h["var"]
    assert h["hedged_assets"] == [data.names[0]]

    w = np.full(2, 0.5)
    sens = sensitivities(data, w, config=cfg, model="heston")
    grad = np.array(list(sens["d_cvar_dw"].values()))
    assert float(w @ grad) == pytest.approx(sens["cvar"], abs=1e-4)
    assert sens["euler_gap_cvar"] < 1e-4
