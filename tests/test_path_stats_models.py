"""Candidate path-stats (terminal + max drawdown) for the GARCH, bootstrap,
Merton and DCC families (lax forms).

These are the GARCH/bootstrap counterparts of gbm_multi_portfolio_dd: W
candidate portfolios compound the per-period rebalanced wealth recursion
``V_{t+1} = V_t (1 + w'r_t)`` (the reference's historical R·w semantics,
/root/reference/app.py:710, applied to simulated paths) with running peak /
max-drawdown carries; ``hedge_args`` switches to per-period option settlement
(mcport.options.hedged, app.py:164-193).

Identity oracle: an all-BUY_ASSET qty-1 HedgeSpec with s0 = 1 makes the hedged
transform compute (p(1+r) - p)/p == r up to rounding — hedged engines must
match their plain forms to float tolerance on the SAME stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.models.bootstrap import bootstrap_path_stats
from mcport.models.garch_mc import CCCGarchParams, garch_path_stats
from mcport.options import HedgeSpec, LegType, Legs

A = 2
NAMES = ["A0", "A1"]
PARAMS = CCCGarchParams(
    mu=np.array([5e-4, 1e-3]),
    omega=np.array([4e-6, 6e-6]),
    alpha=np.array([0.08, 0.12]),
    beta=np.array([0.88, 0.82]),
    corr_chol=np.linalg.cholesky(np.array([[1.0, 0.6], [0.6, 1.0]])),
    sigma2_0=np.array([1e-4, 2e-4]),
    eps2_0=np.array([1e-4, 2e-4]),
)
W = np.array([[0.5, 0.5], [0.2, 0.8], [1.0, 0.0]], np.float32)
IDENTITY = HedgeSpec.build({}, NAMES)
IDENT_ARGS = (np.ones(A, np.float32), *IDENTITY.arrays)


@pytest.fixture(scope="module")
def history():
    rng = np.random.default_rng(42)  # local: immune to suite draw order
    return (rng.standard_t(5, (150, A)) * 0.02 + 0.002).astype(np.float32)


def _protective_put(s0):
    return HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(A)}, NAMES)


# ---- GARCH lax reference ---------------------------------------------------


def test_garch_lax_zero_vol_closed_form():
    p = CCCGarchParams(
        mu=np.array([0.01, -0.005]),
        omega=np.zeros(A), alpha=np.zeros(A), beta=np.zeros(A),
        corr_chol=np.eye(A), sigma2_0=np.zeros(A), eps2_0=np.zeros(A),
    )
    steps = 6
    term, dd = garch_path_stats(jax.random.key(0), p, W, 64, steps)
    r_port = W @ np.array([0.01, -0.005])               # per-period w'mu
    want = (1 + r_port) ** steps - 1
    term, dd = np.asarray(term), np.asarray(dd)
    np.testing.assert_allclose(
        term, np.broadcast_to(want[:, None], term.shape), rtol=5e-5)
    # monotone wealth: dd = 0 for positive drift, full decline for negative
    want_dd = np.minimum((1 + r_port) ** steps - 1, 0.0)
    np.testing.assert_allclose(
        dd, np.broadcast_to(want_dd[:, None], dd.shape), atol=2e-6)


def test_garch_lax_single_weight_vector_and_dd_sign():
    term, dd = garch_path_stats(jax.random.key(1), PARAMS, W[0], 1024, 13)
    assert term.shape == (1, 1024) and dd.shape == (1, 1024)
    d = np.asarray(dd)
    assert (d <= 0).all() and (d >= -1).all()
    # dd bounds terminal decline: V_T/1 - 1 >= min over t of V_t/peak_t - 1
    assert (np.asarray(term) >= d - 1e-6).all()


def test_garch_lax_hedged_identity_matches_plain():
    kw = dict(n_paths=512, n_steps=13)
    t0, d0 = garch_path_stats(jax.random.key(2), PARAMS, W, **kw)
    t1, d1 = garch_path_stats(jax.random.key(2), PARAMS, W, **kw,
                              hedge_args=IDENT_ARGS)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), atol=3e-6)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), atol=3e-6)


# ---- bootstrap lax reference ----------------------------------------------


def test_bootstrap_lax_iid_mean_and_hedged_identity(history):
    n, steps = 8_192, 8
    term, dd = bootstrap_path_stats(jax.random.key(1), history, W, n, steps,
                                    p_restart=1.0)
    term = np.asarray(term, np.float64)
    r_port = history.astype(np.float64) @ W.T.astype(np.float64)  # (T, Wn)
    want = (1 + r_port.mean(0)) ** steps - 1
    se = term.std(1, ddof=1) / np.sqrt(n)
    assert np.all(np.abs(term.mean(1) - want) < 6 * se)
    assert (np.asarray(dd) <= 0).all()
    t1, d1 = bootstrap_path_stats(jax.random.key(1), history, W, 512, 8,
                                  p_restart=1.0)
    t2, d2 = bootstrap_path_stats(jax.random.key(1), history, W, 512, 8,
                                  p_restart=1.0, hedge_args=IDENT_ARGS)
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t1), atol=3e-6)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(d1), atol=3e-6)


def test_bootstrap_lax_same_stream_as_terminal(history):
    """Candidate terminals reproduce w'-compounding of the SAME resampled
    rows as bootstrap_terminal_returns draws (identical (key, step)
    addressing): for a one-hot weight vector the rebalanced wealth equals the
    per-asset gross compound exactly."""
    from mcport.models.bootstrap import bootstrap_terminal_returns

    e0 = np.zeros(A, np.float32)
    e0[0] = 1.0
    term, _ = bootstrap_path_stats(jax.random.key(3), history, e0, 256, 13)
    ref = bootstrap_terminal_returns(jax.random.key(3), history, 256, 13)
    np.testing.assert_allclose(np.asarray(term[0]), np.asarray(ref)[:, 0],
                               atol=2e-6)


# ---- common-jump Merton path stats (late round 3) --------------------------

JUMP_M = np.array([1e-3, 2e-3], np.float32)
JUMP_CHOL = np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5)).astype(np.float32)
JUMP_MU = np.array([-0.15, -0.10], np.float32)
JUMP_SIG = np.array([0.05, 0.04], np.float32)
JUMP_LAM = 0.05


def test_merton_lax_jump_frequency_and_size():
    """One-step decomposition: the fraction of paths whose candidate return
    deviates from the pure-diffusion range matches the Bernoulli rate, and
    jump steps move by ~muJ."""
    from mcport.models.jump import merton_path_stats

    n = 65_536
    big_mu = np.array([-0.5, -0.5], np.float32)       # unmissable jumps
    term, _ = merton_path_stats(jax.random.key(1), np.zeros(2, np.float32),
                                np.diag([1e-4, 1e-4]).astype(np.float32),
                                0.1, big_mu, np.zeros(2, np.float32),
                                np.array([1.0, 0.0], np.float32), n, 1)
    jumped = np.asarray(term[0]) < -0.2
    rate = jumped.mean()
    assert abs(rate - 0.1) < 4 * np.sqrt(0.1 * 0.9 / n)
    np.testing.assert_allclose(np.asarray(term[0])[jumped].mean(),
                               np.exp(-0.5) - 1, atol=0.01)


def test_merton_engine_api_and_family_frontier(fixtures_dir):
    import jax as _jax

    from mcport.api import load_universe, path_tail_risk
    from mcport.config import Config, DataConfig, GBMConfig
    from mcport.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport.engine.path_risk import run_merton_path_risk
    from mcport.models.jump import estimate_merton_common

    data = load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    mp = estimate_merton_common(data.prices)
    cfg_ = GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                     use_pallas=False)
    w = np.full(2, 0.5)
    r = run_merton_path_risk(mp, w, cfg_)
    assert r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert r == run_merton_path_risk(mp, w, cfg_)

    out = path_tail_risk(data, None, Config(gbm=cfg_), model="jump")
    assert out["model"] == "jump" and out["cvar"] <= out["var"]

    fr = family_drawdown_frontier_search(
        _jax.random.key(0), "jump", mp, dd_budget=0.8, n_candidates=64,
        n_paths=512, n_steps=13)
    assert fr.opt_idx >= 0
    fr2 = family_drawdown_frontier_search(
        _jax.random.key(0), "jump", mp, dd_budget=0.8, n_candidates=64,
        n_paths=512, n_steps=13, w_block=32)
    np.testing.assert_array_equal(fr.ret, fr2.ret)


# ---- DCC-GARCH path stats (late round 3) -----------------------------------


def _dcc_params():
    from mcport.models.dcc import DCCGarchParams

    sig0 = np.full(A, 4e-4)
    corr = 0.5 * np.eye(A) + 0.5
    base = CCCGarchParams(
        mu=np.array([5e-4, 1e-3]), omega=sig0 * 0.1,
        alpha=np.full(A, 0.08), beta=np.full(A, 0.9),
        corr_chol=np.linalg.cholesky(corr), sigma2_0=sig0, eps2_0=sig0)
    return DCCGarchParams(base=base, a_dcc=0.06, b_dcc=0.9, q0=corr,
                          e0=np.zeros(A))


def test_dcc_path_stats_static_corr_matches_ccc_law():
    """a_dcc = b_dcc = 0 freezes Q_t = S, so the DCC path stats must match
    the CCC-GARCH path stats in law (same S, independent streams)."""
    import dataclasses

    from mcport.models.dcc import dcc_path_stats
    from mcport.models.garch_mc import garch_path_stats

    dp = dataclasses.replace(_dcc_params(), a_dcc=0.0, b_dcc=0.0)
    n, steps = 8_192, 13
    td, dd_ = dcc_path_stats(jax.random.key(0), dp, W, n, steps)
    tc, dc = garch_path_stats(jax.random.key(1), dp.base, W, n, steps)
    td, dd_, tc, dc = (np.asarray(x, np.float64) for x in (td, dd_, tc, dc))
    se = tc.std(1, ddof=1) / np.sqrt(n)
    assert np.all(np.abs(td.mean(1) - tc.mean(1)) < 6 * se)
    assert np.all(np.abs(td.std(1) / tc.std(1) - 1) < 0.1)
    np.testing.assert_allclose(np.median(dd_, axis=1), np.median(dc, axis=1),
                               atol=0.02)


def test_dcc_engine_api_and_family_frontier(fixtures_dir):
    import jax as _jax

    from mcport.api import load_universe, path_tail_risk
    from mcport.config import Config, DataConfig, GBMConfig
    from mcport.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport.engine.path_risk import run_dcc_path_risk

    dp = _dcc_params()
    cfg_ = GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                     use_pallas=False)
    w = np.full(A, 0.5)
    r = run_dcc_path_risk(dp, w, cfg_)
    assert r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert r == run_dcc_path_risk(dp, w, cfg_)
    with pytest.raises(ValueError, match="s0"):
        run_dcc_path_risk(dp, w, cfg_, hedge=_protective_put([100.0, 50.0]))

    data = load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    out = path_tail_risk(data, None, Config(gbm=cfg_), model="dcc")
    assert out["model"] == "dcc" and out["cvar"] <= out["var"]

    fr = family_drawdown_frontier_search(
        _jax.random.key(0), "dcc", dp, dd_budget=0.5, n_candidates=48,
        n_paths=512, n_steps=13)
    assert fr.opt_idx >= 0
    fr2 = family_drawdown_frontier_search(
        _jax.random.key(0), "dcc", dp, dd_budget=0.5, n_candidates=48,
        n_paths=512, n_steps=13, w_block=16)
    np.testing.assert_array_equal(fr.ret, fr2.ret)


# ---- hedged settlement laws, every lax family ------------------------------


def _family_stats(model, key, n, steps, hedge_args=None, history=None):
    if model == "garch":
        return garch_path_stats(key, PARAMS, W, n, steps, hedge_args=hedge_args)
    if model == "bootstrap":
        return bootstrap_path_stats(key, history, W, n, steps,
                                    hedge_args=hedge_args)
    if model == "jump":
        from mcport.models.jump import merton_path_stats

        return merton_path_stats(key, JUMP_M, JUMP_CHOL, JUMP_LAM, JUMP_MU,
                                 JUMP_SIG, W, n, steps, hedge_args=hedge_args)
    from mcport.models.dcc import dcc_path_stats

    return dcc_path_stats(key, _dcc_params(), W, n, steps,
                          hedge_args=hedge_args)


@pytest.mark.parametrize("model", ["garch", "bootstrap", "jump", "dcc"])
def test_lax_hedged_identity_and_protective_put(model, history):
    """All-BUY_ASSET legs reproduce the plain recursion on the same stream;
    zero-premium protective puts dominate per-period returns, so terminal
    wealth dominates path by path and drawdowns improve in aggregate."""
    key = jax.random.key(5)
    tp, dp = _family_stats(model, key, 512, 13, history=history)
    th, dh = _family_stats(model, key, 512, 13, IDENT_ARGS, history)
    np.testing.assert_allclose(np.asarray(th), np.asarray(tp), atol=3e-6)
    np.testing.assert_allclose(np.asarray(dh), np.asarray(dp), atol=3e-6)
    s0 = np.array([100.0, 50.0], np.float32)
    tr, dr = _family_stats(model, key, 512, 13, (s0, *IDENTITY.arrays), history)
    tq, dq = _family_stats(model, key, 512, 13,
                           (s0, *_protective_put(s0).arrays), history)
    assert (np.asarray(tq) >= np.asarray(tr) - 1e-6).all()
    assert np.asarray(dq).mean() >= np.asarray(dr).mean()
