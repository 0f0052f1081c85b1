"""Simulated max-drawdown risk: lax reference vs Pallas kernel (interpret), sanity laws."""

import jax.numpy as jnp
import numpy as np
import pytest

from mcport.config import GBMConfig, SketchConfig
from mcport.engine.path_risk import DD_SKETCH, run_path_risk
from mcport.models.gbm import GBMParams

A = 3
PARAMS = GBMParams(
    s0=np.array([100.0, 50.0, 20.0]),
    mean_step=np.array([0.002, 0.001, 0.0015]),
    chol_step=np.linalg.cholesky(0.0009 * (0.6 * np.eye(A) + 0.4)),
)
W = np.array([0.5, 0.3, 0.2])


def cfg(**kw):
    base = dict(n_paths=8192, n_steps=16, path_block=2048, seed=3, use_pallas=False)
    base.update(kw)
    return GBMConfig(**base)


def test_report_sanity():
    r = run_path_risk(PARAMS, W, cfg())
    assert -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert -1.0 <= r.dd_mean <= 0.0
    assert r.cvar <= r.var
    assert r.n_paths == 8192
    # drawdown p95 is at least as bad as the terminal VaR when VaR is negative
    # (the running minimum can only be <= the terminal dip)
    if r.var < 0:
        assert r.dd_p95 <= r.var + 1e-6


def test_longer_horizon_worsens_drawdown():
    r_short = run_path_risk(PARAMS, W, cfg(n_steps=4))
    r_long = run_path_risk(PARAMS, W, cfg(n_steps=64))
    assert r_long.dd_p95 < r_short.dd_p95
    assert r_long.dd_mean < r_short.dd_mean


def test_zero_vol_drawdown_exact():
    p = GBMParams(
        s0=np.ones(A) * 10,
        mean_step=np.full(A, -0.01),
        chol_step=np.zeros((A, A)),
    )
    r = run_path_risk(p, np.full(A, 1 / A), cfg(n_steps=5))
    want = np.exp(-0.01 * 5) - 1.0
    bin_w = 1.0 / DD_SKETCH.n_bins
    assert r.dd_mean == pytest.approx(want, abs=1e-6)
    assert r.dd_median == pytest.approx(want, abs=2 * bin_w)


def test_deterministic():
    a = run_path_risk(PARAMS, W, cfg())
    b = run_path_risk(PARAMS, W, cfg())
    assert a == b


# ---- per-period rebalancing semantics (r2) --------------------------------------

def test_rebalanced_kernel_matches_lax_semantics():
    """Interpret-mode kernel vs a from-scratch numpy rebalanced evolution."""
    import jax

    from mcport.models.gbm import simulate_log_paths
    from mcport.ops.pallas_gbm import gbm_path_stats

    a, n, steps = 3, 512, 8
    m = np.array([0.001, 0.002, 0.0005], np.float32)
    chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    term, port, dd = gbm_path_stats(7, m, chol, w, n, steps, interpret=True,
                                    rebalance=True)
    # rebuild the rebalanced wealth from the kernel's own terminal-consistent
    # increments is not directly exposed; instead verify invariants + semantic
    # separation and the lax engine cross-check below.
    assert bool(jnp.all(dd <= 1e-6)) and bool(jnp.all(dd >= -1.0))
    assert bool(jnp.all(port > -1.0))

    # single asset: rebalanced == buy-and-hold identically
    w1 = np.array([1.0], np.float32)
    m1 = np.array([0.001], np.float32)
    c1 = np.array([[0.02]], np.float32)
    _, p_bh, d_bh = gbm_path_stats(9, m1, c1, w1, 512, 8, interpret=True)
    _, p_rb, d_rb = gbm_path_stats(9, m1, c1, w1, 512, 8, interpret=True,
                                   rebalance=True)
    np.testing.assert_allclose(np.asarray(p_rb), np.asarray(p_bh), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(d_rb), np.asarray(d_bh), atol=2e-5)


def test_lax_rebalanced_oracle(rng):
    """The lax rebalanced path-stats equals an explicit numpy recomputation
    from the same simulated log paths."""
    import jax
    import jax.numpy as jnp

    from mcport.engine.path_risk import _lax_path_stats
    from mcport.models.gbm import simulate_log_paths

    a, n, steps = 3, 256, 6
    m = np.array([0.002, 0.001, 0.0015])
    chol = np.linalg.cholesky(9e-4 * (0.6 * np.eye(a) + 0.4))
    w = np.array([0.4, 0.35, 0.25])
    key = jax.random.key(3)
    port, dd = _lax_path_stats(key, jnp.asarray(m), jnp.asarray(chol),
                               jnp.asarray(w), n, steps, jnp.float64, True)
    paths = np.asarray(simulate_log_paths(key, m, chol, n, steps,
                                          dtype=jnp.float64))
    inc = np.diff(paths, axis=1, prepend=np.zeros((n, 1, a)))
    growth = np.exp(inc) @ w
    v = np.concatenate([np.ones((n, 1)), np.cumprod(growth, axis=1)], axis=1)
    np.testing.assert_allclose(np.asarray(port), v[:, -1] - 1, rtol=1e-10)
    peak = np.maximum.accumulate(v, axis=1)
    np.testing.assert_allclose(np.asarray(dd), (v / peak - 1).min(axis=1),
                               atol=1e-12)


def test_rebalanced_engine_differs_from_buy_and_hold():
    from mcport.config import GBMConfig
    from mcport.engine.path_risk import run_path_risk
    from mcport.models.gbm import GBMParams

    a = 2
    params = GBMParams(s0=np.ones(a), mean_step=np.array([0.004, -0.001]),
                       chol_step=np.diag([0.05, 0.03]))
    w = np.array([0.5, 0.5])
    cfg = GBMConfig(n_paths=32_768, n_steps=26, path_block=8_192,
                    use_pallas=False, seed=2)
    bh = run_path_risk(params, w, cfg)
    rb = run_path_risk(params, w, cfg, rebalance=True)
    # with drifting weights the two portfolio processes genuinely differ
    assert abs(bh.port_mean - rb.port_mean) > 1e-4
    assert bh.var != rb.var


def test_run_path_risk_hedged_per_period():
    """Hedged path risk (W=1 through the hedged scorer): identity hedge
    matches rebalance mode; protective puts improve the dd distribution."""
    from mcport.options import HedgeSpec, LegType, Legs

    a = 3
    rng = np.random.default_rng(9)
    corr = 0.4 * np.eye(a) + 0.6
    vols = np.array([0.05, 0.06, 0.04])
    p = GBMParams(s0=np.array([100.0, 50.0, 20.0]),
                  mean_step=np.full(a, 1e-3),
                  chol_step=np.linalg.cholesky(vols[:, None] * vols[None, :] * corr))
    cfg = GBMConfig(n_paths=4096, path_block=2048, n_steps=13, use_pallas=False)
    w = np.full(a, 1.0 / a)
    names = ["X0", "X1", "X2"]

    ident = HedgeSpec.build({}, names)
    base = run_path_risk(p, w, cfg, rebalance=True)
    # identity spec over s0 != 1 evaluates (S-s0*...)/prev per step == plain
    # per-period return: same LAW and nearly the same numbers (op order)
    hid = run_path_risk(p, w, cfg, hedge=ident)
    assert abs(hid.dd_p95 - base.dd_p95) < 5e-3
    assert abs(hid.port_mean - base.port_mean) < 5e-3

    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(p.s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(a)}, names)
    hp = run_path_risk(p, w, cfg, hedge=prot)
    assert hp.dd_mean > base.dd_mean
    assert hp.var > base.var


# ---- model-family path risk (round 3): GARCH + bootstrap ------------------


def _history():
    rng = np.random.default_rng(11)
    return (rng.standard_t(6, (200, A)) * 0.02 + 0.002).astype(np.float32)


def test_garch_path_risk_sanity_and_deterministic():
    from mcport.engine.path_risk import run_garch_path_risk
    from mcport.models.garch_mc import estimate_ccc_garch

    gp = estimate_ccc_garch(_history())
    r = run_garch_path_risk(gp, W, cfg())
    assert -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert r.cvar <= r.var
    assert r.n_paths == 8192
    if r.var < 0:
        assert r.dd_p95 <= r.var + 1e-6
    assert r == run_garch_path_risk(gp, W, cfg())
    # longer horizon worsens the drawdown distribution
    r_long = run_garch_path_risk(gp, W, cfg(n_steps=64))
    assert r_long.dd_p95 < r.dd_p95


def test_bootstrap_path_risk_sanity_and_deterministic():
    from mcport.engine.path_risk import run_bootstrap_path_risk

    h = _history()
    r = run_bootstrap_path_risk(h, W, cfg())
    assert -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
    assert r.cvar <= r.var
    assert r == run_bootstrap_path_risk(h, W, cfg())
    r_long = run_bootstrap_path_risk(h, W, cfg(n_steps=64))
    assert r_long.dd_p95 < r.dd_p95


def test_family_path_risk_hedged_put_improves_tail():
    from mcport.engine.path_risk import run_bootstrap_path_risk, run_garch_path_risk
    from mcport.models.garch_mc import estimate_ccc_garch
    from mcport.options import HedgeSpec, LegType, Legs

    h = _history()
    s0 = np.array([100.0, 50.0, 20.0])
    names = ["X0", "X1", "X2"]
    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(A)}, names)
    gp = estimate_ccc_garch(h)
    base_g = run_garch_path_risk(gp, W, cfg())
    prot_g = run_garch_path_risk(gp, W, cfg(), hedge=prot, s0=s0)
    assert prot_g.dd_mean > base_g.dd_mean
    base_b = run_bootstrap_path_risk(h, W, cfg())
    prot_b = run_bootstrap_path_risk(h, W, cfg(), hedge=prot, s0=s0)
    assert prot_b.dd_mean > base_b.dd_mean
    # hedged without s0 refuses
    with pytest.raises(ValueError, match="s0"):
        run_garch_path_risk(gp, W, cfg(), hedge=prot)
    with pytest.raises(ValueError, match="s0"):
        run_bootstrap_path_risk(h, W, cfg(), hedge=prot)


def test_api_path_tail_risk_families(fixtures_dir):
    from mcport.api import load_universe, path_tail_risk
    from mcport.config import Config, DataConfig, GBMConfig

    data = load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    cfg_ = Config(gbm=GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                                use_pallas=False))
    for model in ("gbm", "garch", "bootstrap"):
        out = path_tail_risk(data, None, cfg_, model=model)
        assert out["model"] == model
        assert out["cvar"] <= out["var"]
        assert -1.0 <= out["dd_p95"] <= out["dd_median"] <= 0.0
    with pytest.raises(ValueError, match="model must be"):
        path_tail_risk(data, None, cfg_, model="nope")
    # hedged route: zero-premium married put on BTC improves every family's dd
    from mcport.options import LegType, Legs

    legs = {data.names[0]: Legs.from_rows(
        [(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
         (LegType.BUY_PUT, float(data.prices[-1, 0]) * 0.95, 0.0, 1.0)])}
    for model in ("gbm", "garch", "bootstrap"):
        base = path_tail_risk(data, None, cfg_, model=model)
        hedged = path_tail_risk(data, None, cfg_, model=model,
                                legs_by_asset=legs)
        assert hedged["hedged_assets"] == [data.names[0]]
        assert hedged["dd_mean"] >= base["dd_mean"] - 1e-9


# ---- Student-t innovations across the path tier (late round 3) ------------


def test_lax_t_paths_oracle_and_unit_variance():
    """simulate_log_paths(t_df=...) has the SAME per-step covariance as the
    normal law (unit-variance scaling) and heavier tails; _lax_path_stats
    over t paths equals a numpy recompute from the same paths."""
    import jax
    import jax.numpy as jnp

    from mcport.engine.path_risk import _lax_path_stats
    from mcport.models.gbm import simulate_log_paths

    a, n, steps, df = 2, 32_768, 4, 5.0
    m = np.zeros(a)
    chol = np.diag([0.02, 0.03])
    key = jax.random.key(0)
    pt = np.asarray(simulate_log_paths(key, m, chol, n, steps,
                                       dtype=jnp.float64, t_df=df))
    inc = np.diff(pt, axis=1, prepend=np.zeros((n, 1, a)))
    # unit-variance scaling: per-step std matches the Cholesky diagonal
    np.testing.assert_allclose(inc.reshape(-1, a).std(axis=0),
                               [0.02, 0.03], rtol=0.05)
    # heavier tails than normal: excess kurtosis of t_5 scaled = 6/(df-4) = 6
    k = ((inc[..., 0] / 0.02) ** 4).mean()
    assert k > 4.5  # normal = 3; MC spread is wide for t_5's 4th moment

    w = np.array([0.5, 0.5])
    port, dd = _lax_path_stats(key, jnp.asarray(m), jnp.asarray(chol),
                               jnp.asarray(w), n, steps, jnp.float64,
                               False, df)
    v = np.concatenate([np.ones((n, 1)), np.exp(pt) @ w], axis=1)
    np.testing.assert_allclose(np.asarray(port), v[:, -1] - 1, rtol=1e-10)
    peak = np.maximum.accumulate(v, axis=1)
    np.testing.assert_allclose(np.asarray(dd), (v / peak - 1).min(axis=1),
                               atol=1e-12)


def test_t_path_stats_kernel_law():
    """gbm_path_stats(t_df=...) interpret kernel vs the lax t reference:
    matching terminal/drawdown law; variance matches the normal kernel
    (unit-variance scaling)."""
    import jax
    import jax.numpy as jnp

    from mcport.engine.path_risk import _lax_path_stats
    from mcport.ops.pallas_gbm import gbm_path_stats

    a, n, steps, df = 3, 8_192, 13, 6.0
    m = np.array([0.001, 0.002, 0.0005], np.float32)
    chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    _, port_t, dd_t = gbm_path_stats(7, m, chol, w, n, steps, interpret=True,
                                     t_df=df)
    port_l, dd_l = _lax_path_stats(jax.random.key(3), jnp.asarray(m),
                                   jnp.asarray(chol), jnp.asarray(w), n,
                                   steps, jnp.float64, False, df)
    port_t, dd_t = np.asarray(port_t, np.float64), np.asarray(dd_t, np.float64)
    port_l, dd_l = np.asarray(port_l), np.asarray(dd_l)
    se = port_l.std(ddof=1) / np.sqrt(n)
    assert abs(port_t.mean() - port_l.mean()) < 6 * se
    assert abs(port_t.std() / port_l.std() - 1) < 0.1
    assert abs(np.median(dd_t) - np.median(dd_l)) < 0.03
    # unit-variance scaling: t terminal std ~ normal terminal std
    _, port_n, _ = gbm_path_stats(7, m, chol, w, n, steps, interpret=True)
    assert abs(port_t.std() / np.asarray(port_n, np.float64).std() - 1) < 0.15


def test_t_multi_dd_kernel_and_frontier():
    """multi-dd t scoring: law parity vs the lax t scorer; the frontier
    accepts t_df end-to-end (kernel path incl. bf16 rescore)."""
    import jax
    import jax.numpy as jnp

    from mcport.engine.drawdown_frontier import (
        _lax_multi_dd, drawdown_frontier_search,
    )
    from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

    a, n, steps, df = 3, 4_096, 13, 5.5   # suite diet: tolerances se-scaled
    m = np.full(a, 1e-3, np.float32)
    chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
    cand = np.asarray(jax.random.dirichlet(jax.random.key(0), jnp.ones(a), (8,)),
                      np.float32)
    t_k, d_k = gbm_multi_portfolio_dd(3, m, chol, cand, n, steps,
                                      interpret=True, block=512, t_df=df)
    t_l, d_l = _lax_multi_dd(jax.random.key(5), jnp.asarray(m, jnp.float64),
                             jnp.asarray(chol, jnp.float64),
                             jnp.asarray(cand, jnp.float64), n, steps,
                             jnp.float64, False, df)
    t_k, d_k = np.asarray(t_k, np.float64), np.asarray(d_k, np.float64)
    t_l, d_l = np.asarray(t_l), np.asarray(d_l)
    se = t_l.std(1, ddof=1) / np.sqrt(n)
    assert np.all(np.abs(t_k.mean(1) - t_l.mean(1)) < 6 * se)
    assert np.all(np.abs(t_k.std(1) / t_l.std(1) - 1) < 0.12)
    np.testing.assert_allclose(np.median(d_k, axis=1), np.median(d_l, axis=1),
                               atol=0.02)

    # SUBPROCESS on purpose: compiling the interpret-mode t + bf16 +
    # rescore frontier graph segfaults XLA's CPU backend in long-lived
    # full-suite processes (reproducible at 6 or 13 steps; fine in a fresh
    # process) — isolate the e2e check so the suite survives the compiler
    # bug while still exercising the full kernel path.
    import subprocess
    import sys

    script = """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from mcport.engine.drawdown_frontier import drawdown_frontier_search
from mcport.models.gbm import GBMParams
from mcport.ops import dispatch

dispatch._interpret = True     # the kernel path, interpreted on the CPU
a = 3
m = np.full(a, 1e-3, np.float32)
chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
r = drawdown_frontier_search(
    jax.random.key(6), GBMParams(s0=np.ones(a), mean_step=m, chol_step=chol),
    dd_budget=0.4, n_candidates=48, n_paths=512, n_steps=6,
    use_pallas=True, t_df=5.5,
    score_dtype="bfloat16", rescore_top=4)
assert r.opt_idx >= 0 and r.dd_p95[r.opt_idx] >= -0.4
print("T_FRONTIER_OK")
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600,
                         cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert "T_FRONTIER_OK" in out.stdout, out.stderr[-2000:]


def test_run_path_risk_student_t_config():
    """innovations="student_t" flows through the engine (lax tier): fatter
    drawdown tail than normal at the same covariance, deterministic."""
    import dataclasses

    base = cfg(n_paths=16_384, path_block=8_192, n_steps=26)
    t_cfg = dataclasses.replace(base, innovations="student_t", t_dof=5.0)
    rn = run_path_risk(PARAMS, W, base)
    rt = run_path_risk(PARAMS, W, t_cfg)
    assert rt != rn
    # same per-step covariance, fatter tails: the extreme drawdown quantile
    # is at least as bad under t (weak MC-robust direction)
    assert rt.dd_p95 <= rn.dd_p95 + 5e-3
    assert rt == run_path_risk(PARAMS, W, t_cfg)
    # hedged + t composes (lax hedged scorer)
    from mcport.options import HedgeSpec

    ident = HedgeSpec.build({}, ["X0", "X1", "X2"])
    rth = run_path_risk(PARAMS, W, t_cfg, hedge=ident)
    assert np.isfinite([rth.var, rth.dd_p95]).all()


# ---- QMC bridge path risk (late round 3) ----------------------------------


def test_qmc_path_risk_matches_mc_law_and_is_deterministic():
    """Brownian-bridge Sobol path risk agrees with the MC engine's law and
    is deterministic; student_t + qmc refuses."""
    import dataclasses

    base = cfg(n_paths=8192, path_block=4096, n_steps=16)
    q_cfg = dataclasses.replace(base, qmc="sobol")
    mc = run_path_risk(PARAMS, W, cfg(n_paths=32_768, path_block=8_192,
                                      n_steps=16))
    qr = run_path_risk(PARAMS, W, q_cfg)
    assert qr.cvar <= qr.var
    assert -1.0 <= qr.dd_p95 <= qr.dd_median <= 0.0
    # same law: QMC converges to the same quantities (tolerance covers the
    # 32k-MC reference's own error)
    assert abs(qr.port_mean - mc.port_mean) < 0.01
    assert abs(qr.dd_median - mc.dd_median) < 0.02
    assert abs(qr.var - mc.var) < 0.03
    assert qr == run_path_risk(PARAMS, W, q_cfg)
    # rebalanced + halton route
    h_cfg = dataclasses.replace(base, qmc="halton")
    rh = run_path_risk(PARAMS, W, h_cfg, rebalance=True)
    assert np.isfinite([rh.var, rh.dd_p95]).all()
    with pytest.raises(ValueError, match="student_t"):
        run_path_risk(PARAMS, W, dataclasses.replace(
            q_cfg, innovations="student_t", t_dof=5.0))


def test_qmc_path_risk_hedged_identity_and_put():
    import dataclasses

    from mcport.options import HedgeSpec, LegType, Legs

    names = ["X0", "X1", "X2"]
    q_cfg = dataclasses.replace(cfg(n_paths=4096, path_block=4096,
                                    n_steps=13), qmc="sobol")
    ident = HedgeSpec.build({}, names)
    base = run_path_risk(PARAMS, W, q_cfg, rebalance=True)
    hid = run_path_risk(PARAMS, W, q_cfg, hedge=ident)
    # identity legs == rebalanced scoring on the SAME Sobol paths
    assert abs(hid.port_mean - base.port_mean) < 5e-3
    assert abs(hid.dd_median - base.dd_median) < 5e-3
    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(PARAMS.s0[i]) * 0.98,
                             0.0, 1.0)])
         for i in range(A)}, names)
    hp = run_path_risk(PARAMS, W, q_cfg, hedge=prot)
    assert hp.dd_mean > base.dd_mean


# ---- resumable path risk across every family (late round 3) ---------------


def test_resumable_path_risk_bit_exact_split_all_families(tmp_path):
    """A preemption-split run equals the unsplit run BIT-EXACTLY for every
    model family (counter-addressed block streams), checkpoints survive a
    save/load round trip, and digest binding rejects a mismatched resume."""
    import dataclasses

    from mcport.engine.path_risk import (
        load_path_risk_checkpoint, run_resumable_path_risk,
    )
    from mcport.models.dcc import DCCGarchParams
    from mcport.models.garch_mc import CCCGarchParams, estimate_ccc_garch
    from mcport.models.jump import MertonParams

    rng = np.random.default_rng(13)
    hist = (rng.standard_t(6, (160, A)) * 0.02 + 0.002).astype(np.float32)
    gp = estimate_ccc_garch(hist)
    corr = np.asarray(gp.corr_chol @ gp.corr_chol.T, np.float64)
    dcp = DCCGarchParams(base=gp, a_dcc=0.05, b_dcc=0.85, q0=corr,
                         e0=np.zeros(A))
    mp = MertonParams(diffusion=PARAMS, jump_rate=0.05,
                      jump_mean=np.full(A, -0.1), jump_vol=np.full(A, 0.05))
    c = cfg(n_paths=4096, path_block=1024, n_steps=8)

    families = [("gbm", PARAMS), ("garch", gp), ("dcc", dcp), ("jump", mp),
                ("bootstrap", hist),
                ("student_t", PARAMS)]
    for model, params_ in families:
        mc = (dataclasses.replace(c, innovations="student_t", t_dof=5.0)
              if model == "student_t" else c)
        full, ck_full = run_resumable_path_risk(model, params_, W, mc)
        assert ck_full.done and full.n_paths == 4096
        part, ck1 = run_resumable_path_risk(model, params_, W, mc,
                                            max_blocks=2)
        assert not ck1.done and part.n_paths == 2048
        path = tmp_path / f"{model}.npz"
        ck1.save(path)
        resumed, ck2 = run_resumable_path_risk(
            model, params_, W, mc,
            checkpoint=load_path_risk_checkpoint(path))
        assert ck2.done, model
        assert resumed == full, model
        # resuming a DONE checkpoint is a no-op with identical stats
        again, _ = run_resumable_path_risk(model, params_, W, mc,
                                           checkpoint=ck2)
        assert again == full, model

    # digest binds: different weights is a different computation
    _, ck = run_resumable_path_risk("garch", gp, W, c, max_blocks=1)
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("garch", gp, np.array([0.2, 0.3, 0.5]), c,
                                checkpoint=ck)
    with pytest.raises(ValueError, match="model must be"):
        run_resumable_path_risk("nope", gp, W, c)


def test_resumable_path_risk_matches_oneshot_engines():
    """The resumable driver's accumulation equals the one-shot family
    engines (same block streams, same sketches)."""
    from mcport.engine.path_risk import (
        run_bootstrap_path_risk, run_garch_path_risk, run_resumable_path_risk,
    )
    from mcport.models.garch_mc import estimate_ccc_garch

    rng = np.random.default_rng(17)
    hist = (rng.standard_t(6, (160, A)) * 0.02 + 0.002).astype(np.float32)
    gp = estimate_ccc_garch(hist)
    c = cfg(n_paths=4096, path_block=2048, n_steps=8)
    r1, ck = run_resumable_path_risk("garch", gp, W, c)
    r2 = run_garch_path_risk(gp, W, c)
    assert r1 == r2
    b1, _ = run_resumable_path_risk("bootstrap", hist, W, c)
    b2 = run_bootstrap_path_risk(hist, W, c)
    assert b1 == b2


def test_resumable_path_risk_recovery_survives_aborts(tmp_path, monkeypatch):
    """Elastic driver: segments that raise JaxRuntimeError resume from the
    durable checkpoint and the final result is bit-identical to an
    uninterrupted run; a permanently-failing device re-raises."""
    import jax

    import mcport.engine.path_risk as pr
    from mcport.engine.path_risk import (
        run_resumable_path_risk, run_resumable_path_risk_with_recovery,
    )
    from mcport.models.garch_mc import estimate_ccc_garch

    rng = np.random.default_rng(19)
    hist = (rng.standard_t(6, (150, A)) * 0.02 + 0.002).astype(np.float32)
    gp = estimate_ccc_garch(hist)
    c = cfg(n_paths=4096, path_block=1024, n_steps=8)
    clean, _ = run_resumable_path_risk("garch", gp, W, c)

    real = pr.run_resumable_path_risk
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] in (2, 4):  # abort two mid-run segments
            raise jax.errors.JaxRuntimeError("ABORTED: device backend error")
        return real(*a, **kw)

    monkeypatch.setattr(pr, "run_resumable_path_risk", flaky)
    path = tmp_path / "pr.npz"
    rep = run_resumable_path_risk_with_recovery(
        "garch", gp, W, c, checkpoint_path=path, segment_blocks=1)
    assert rep == clean
    assert calls["n"] >= 6  # 4 data segments + 2 aborts

    # permanent failure re-raises after max_restarts
    def always_fail(*a, **kw):
        raise jax.errors.JaxRuntimeError("ABORTED: device backend error")

    monkeypatch.setattr(pr, "run_resumable_path_risk", always_fail)
    with pytest.raises(jax.errors.JaxRuntimeError):
        run_resumable_path_risk_with_recovery(
            "garch", gp, W, c, checkpoint_path=tmp_path / "pr2.npz",
            segment_blocks=1, max_restarts=2)


def test_resumable_path_risk_refuses_qmc():
    import dataclasses

    from mcport.engine.path_risk import run_resumable_path_risk

    with pytest.raises(ValueError, match="qmc"):
        run_resumable_path_risk("gbm", PARAMS, W,
                                dataclasses.replace(cfg(), qmc="sobol"))


def test_path_risk_bm_digest_and_lax_invariance():
    """config.bm="poly_fast" (round-4 screening tier) is stream-affecting on
    the kernel path, so the resumable digest must change; default-config
    digests are unchanged and the lax engine ignores bm entirely."""
    import dataclasses

    from mcport.engine.path_risk import _model_digest

    c = cfg()
    fast = dataclasses.replace(c, bm="poly_fast")
    assert (_model_digest("gbm", PARAMS, W, fast, None, None, 0.2, True)
            != _model_digest("gbm", PARAMS, W, c, None, None, 0.2, True))
    # lax path (use_pallas=False here): bm is kernel-only, results identical
    r_fast = run_path_risk(PARAMS, W, fast)
    r_def = run_path_risk(PARAMS, W, c)
    assert r_fast == r_def
