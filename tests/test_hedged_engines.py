"""Hedged simulated-tier engines: identity parity, tail-protection laws,
checkpoint digests, and the mesh form.

Identity oracle: a HedgeSpec with no explicit legs is all implicit BUY_ASSET
qty-1 rows; with s0 = 1 the hedged transform computes exactly
``exp(term) - 1`` (same float ops), so hedged engines must be BIT-EQUAL to
their unhedged forms — the strongest possible wiring check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.config import Config, GBMConfig
from mcport.engine.drawdown_frontier import drawdown_frontier_search
from mcport.engine.mc_engine import run_resumable_mc
from mcport.engine.simulated_frontier import (
    simulated_weight_search,
    simulated_weight_search_streaming,
)
from mcport.models.gbm import GBMParams
from mcport.options import HedgeSpec, LegType, Legs

A = 4
NAMES = ["A0", "A1", "A2", "A3"]


def _params(s0=None):
    rng = np.random.default_rng(7)
    corr = 0.4 * np.eye(A) + 0.6
    vols = np.array([0.05, 0.06, 0.03, 0.08])
    cov = vols[:, None] * vols[None, :] * corr
    return GBMParams(
        s0=np.ones(A) if s0 is None else np.asarray(s0, np.float64),
        mean_step=np.array([1e-3, 5e-4, 8e-4, 2e-3]),
        chol_step=np.linalg.cholesky(cov),
    )


IDENTITY = HedgeSpec.build({}, NAMES)

# married put (zero premium) on every asset: payoff is max(S,K)-ish, which
# dominates the plain asset below strike — tail metrics must improve
PROTECTED = HedgeSpec.build(
    {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                        (LegType.BUY_PUT, 0.97, 0.0, 1.0)]) for i in range(A)},
    NAMES,
)


def test_sim_frontier_identity_bit_equal():
    p = _params()
    kw = dict(n_candidates=512, n_paths=2048, n_steps=26, objective="cvar")
    base = simulated_weight_search(jax.random.key(0), p, **kw)
    hedged = simulated_weight_search(jax.random.key(0), p, hedge=IDENTITY, **kw)
    assert base.opt_idx == hedged.opt_idx
    np.testing.assert_array_equal(base.cvar, hedged.cvar)
    np.testing.assert_array_equal(base.weights, hedged.weights)


def test_sim_frontier_put_protection_improves_cvar():
    p = _params()
    kw = dict(n_candidates=256, n_paths=4096, n_steps=26, objective="cvar")
    base = simulated_weight_search(jax.random.key(1), p, **kw)
    prot = simulated_weight_search(jax.random.key(1), p, hedge=PROTECTED, **kw)
    # same candidates (same key), per-candidate CVaR must be >= unhedged
    assert (prot.cvar >= base.cvar - 1e-6).all()
    assert prot.cvar[prot.opt_idx] > base.cvar[base.opt_idx]


def test_streaming_identity_matches_unhedged():
    p = _params()
    kw = dict(n_candidates=4096, n_paths=1024, n_steps=13, cand_block=1024,
              objective="cvar")
    base = simulated_weight_search_streaming(jax.random.key(2), p, **kw)
    hedged = simulated_weight_search_streaming(jax.random.key(2), p,
                                               hedge=IDENTITY, **kw)
    np.testing.assert_array_equal(base.opt_weights, hedged.opt_weights)
    assert base.opt_metric == hedged.opt_metric


def test_gbm_risk_engine_hedged_identity_and_protection():
    p = _params()
    cfg = GBMConfig(n_paths=8192, path_block=4096, n_steps=26, use_pallas=False)
    w = np.full(A, 0.25)
    base, _ = run_resumable_mc(p, w, cfg)
    prot, _ = run_resumable_mc(p, w, cfg, hedge=PROTECTED)
    # zero-premium put floors each asset's loss at strike: tail improves
    assert prot.var > base.var
    assert prot.cvar > base.cvar
    # moments stay the plain log-return moments
    np.testing.assert_allclose(prot.mean, base.mean, atol=1e-12)


def test_gbm_risk_hedged_sketch_vs_exact_topk():
    """One-block run: replay the engine's stream exactly and compare sketch
    tail metrics to exact top-k within a bin width."""
    import math

    from mcport.models.gbm import terminal_log_returns
    from mcport.options.hedged import auto_hedged_sketch, hedged_terminal_returns
    from mcport.seeding import SEED_STRIDE

    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    spec = HedgeSpec.build(
        {"A0": Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                               (LegType.BUY_PUT, 95.0, 1.5, 1.0)])}, NAMES)
    n = 16_384
    cfg = GBMConfig(n_paths=n, path_block=n, n_steps=26, seed=5, use_pallas=False)
    w = np.full(A, 0.25)
    rep, _ = run_resumable_mc(p, w, cfg, hedge=spec)

    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             jnp.asarray(cfg.seed + SEED_STRIDE, jnp.int32))
    term = terminal_log_returns(
        key, jnp.asarray(p.mean_step, jnp.float32),
        jnp.asarray(p.chol_step, jnp.float32), n, cfg.n_steps)
    port = np.asarray(hedged_terminal_returns(
        term, jnp.asarray(p.s0, jnp.float32), *spec.arrays) @ jnp.asarray(w, jnp.float32))
    k = max(1, math.ceil(0.05 * n))
    worst = np.sort(port)[:k]
    sk = auto_hedged_sketch(p, cfg.n_steps, spec, weights=w)
    bin_w = (sk.hi - sk.lo) / sk.n_bins
    assert abs(rep.var - (-(-worst[-1]))) < 2 * bin_w
    assert abs(rep.cvar - worst.mean()) < 2 * bin_w
    assert abs(rep.port_mean - port.mean()) < 1e-6


def test_hedged_checkpoint_digest_binds(tmp_path):
    p = _params()
    cfg = GBMConfig(n_paths=4096, path_block=2048, n_steps=13, use_pallas=False)
    w = np.full(A, 0.25)
    path = tmp_path / "ck.npz"
    _, ck = run_resumable_mc(p, w, cfg, hedge=PROTECTED, max_blocks=1,
                             checkpoint_path=path)
    # resuming WITHOUT the hedge is a different computation: refuse
    with pytest.raises(ValueError, match="digest"):
        run_resumable_mc(p, w, cfg, checkpoint=ck)
    # with it: completes and is bit-identical to an unsplit run
    full_split, _ = run_resumable_mc(p, w, cfg, hedge=PROTECTED, checkpoint=ck)
    full, _ = run_resumable_mc(p, w, cfg, hedge=PROTECTED)
    assert full_split.var == full.var and full_split.cvar == full.cvar


def test_dd_frontier_hedged_identity_close_to_rebalance():
    """Identity hedge == rebalanced scoring up to simplex-sum rounding
    (1 + w'(exp(x)-1) vs w'exp(x): equal when sum(w) == 1 exactly)."""
    p = _params()
    kw = dict(dd_budget=0.25, n_candidates=64, n_paths=512, n_steps=13)
    base = drawdown_frontier_search(jax.random.key(3), p, use_pallas=False,
                                    rebalance=True, **kw)
    hedged = drawdown_frontier_search(jax.random.key(3), p, hedge=IDENTITY, **kw)
    np.testing.assert_allclose(hedged.ret, base.ret, atol=2e-5)
    np.testing.assert_allclose(hedged.dd_p95, base.dd_p95, atol=2e-5)


def test_dd_frontier_hedged_put_lifts_drawdown_floor():
    p = _params()
    kw = dict(dd_budget=0.5, n_candidates=128, n_paths=2048, n_steps=26)
    base = drawdown_frontier_search(jax.random.key(4), p, use_pallas=False,
                                    rebalance=True, **kw)
    prot = drawdown_frontier_search(jax.random.key(4), p, hedge=PROTECTED, **kw)
    # per-period zero-premium puts dominate per-period returns, so the
    # candidate drawdown DISTRIBUTION improves in aggregate (pointwise
    # domination is not a theorem: put payouts can raise early peaks)
    assert prot.dd_p95.mean() > base.dd_p95.mean()
    assert np.median(prot.dd_p95) > np.median(base.dd_p95)


def test_sharded_hedged_matches_law(eight_devices):
    from jax.sharding import Mesh

    from mcport.parallel.sharded_engines import sharded_hedged_gbm_risk

    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    spec = HedgeSpec.build(
        {"A1": Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                               (LegType.BUY_PUT, 48.0, 0.5, 1.0)])}, NAMES)
    w = np.full(A, 0.25)
    mesh = Mesh(np.array(eight_devices), ("paths",))
    v, c, m = sharded_hedged_gbm_risk(0, p, w, spec, n_paths=65_536,
                                      n_steps=13, mesh=mesh)
    v, c, m = float(v), float(c), float(m)
    assert np.isfinite([v, c, m]).all() and c <= v
    # deterministic
    v2, c2, m2 = sharded_hedged_gbm_risk(0, p, w, spec, n_paths=65_536,
                                         n_steps=13, mesh=mesh)
    assert (v, c, m) == (float(v2), float(c2), float(m2))


@pytest.fixture(scope="module")
def weekly_data(fixtures_dir):
    from mcport.api import load_universe
    from mcport.config import DataConfig

    return load_universe(
        paths=[fixtures_dir / "BTC_USD 7 Years Weekly.csv",
               fixtures_dir / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )


def test_api_hedged_tail_risk_families(weekly_data):
    from mcport.api import gbm_risk, hedged_tail_risk

    data = weekly_data
    a = len(data.names)
    legs = {data.names[0]: Legs.from_rows(
        [(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
         (LegType.BUY_PUT, float(data.prices[-1, 0]) * 0.95, 0.0, 1.0)])}
    cfg = Config(gbm=GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                               use_pallas=False))
    outs = {}
    for model in ("gbm", "student_t", "garch", "bootstrap"):
        outs[model] = hedged_tail_risk(data, None, cfg, legs, model=model)
        assert outs[model]["cvar"] <= outs[model]["var"]
        assert outs[model]["hedged_assets"] == [data.names[0]]
    with pytest.raises(ValueError, match="model must be"):
        hedged_tail_risk(data, None, cfg, legs, model="nope")
    # engine route: gbm_risk accepts legs_by_asset and the zero-premium put
    # improves the tail vs unhedged
    base = gbm_risk(data, None, cfg)
    hedged = gbm_risk(data, None, cfg, legs_by_asset=legs)
    assert hedged.cvar >= base.cvar


# ---- hedged Pallas multi-dd kernel (round 3) -------------------------------


def _spec_args(spec, s0, dtype=jnp.float32):
    import jax.numpy as _jnp

    return (_jnp.asarray(s0, dtype), *spec.arrays)


def test_hedged_kernel_matches_lax_scorer():
    """Interpret-mode hedged multi-dd kernel vs _lax_multi_dd_hedged: same
    per-step settlement semantics, same law (independent streams) — compared
    via a SHARED-paths construction: the lax scorer replays the kernel's
    exact settlement math on its own paths, so here we assert the kernel's
    identity-hedge case equals its own rebalance mode (bit-level semantics)
    and the put-hedged dd dominates unhedged, path by path."""
    import jax.numpy as jnp_

    from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    mean = jnp.asarray(p.mean_step, jnp.float32)
    chol = jnp.asarray(p.chol_step, jnp.float32)
    w = np.asarray(jax.random.dirichlet(jax.random.key(0), jnp.ones(A), (8,)),
                   np.float32)
    kw = dict(interpret=True, block=128)

    # identity hedge == rebalance mode up to simplex-sum rounding
    ident = _spec_args(IDENTITY, np.ones(A))
    t_h, d_h = gbm_multi_portfolio_dd(3, mean, chol, w, 256, 13,
                                      hedge_args=ident, **kw)
    t_r, d_r = gbm_multi_portfolio_dd(3, mean, chol, w, 256, 13,
                                      rebalance=True, **kw)
    np.testing.assert_allclose(np.asarray(t_h), np.asarray(t_r), atol=3e-5)
    np.testing.assert_allclose(np.asarray(d_h), np.asarray(d_r), atol=3e-5)

    # zero-premium protective puts can only lift drawdowns, path by path
    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(p.s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(A)}, NAMES)
    t_p, d_p = gbm_multi_portfolio_dd(3, mean, chol, w, 256, 13,
                                      hedge_args=_spec_args(prot, p.s0), **kw)
    # zero-premium puts dominate TERMINAL wealth path-by-path; drawdowns
    # improve in aggregate but not pointwise (a put payout can raise an
    # early peak and deepen a later RELATIVE drawdown)
    assert (np.asarray(t_p) >= np.asarray(t_r) - 1e-6).all()
    assert np.asarray(d_p).mean() > np.asarray(d_r).mean()

    # scoring tiers compose: bf16 screen stays within the pinned bound
    from mcport.ops.pallas_multi_dd import BF16_DD_ERR_BOUND, BF16_DD_ERR_REBAL_COEF

    t_b, d_b = gbm_multi_portfolio_dd(3, mean, chol, w, 256, 13,
                                      hedge_args=_spec_args(prot, p.s0),
                                      score_dtype="bfloat16", **kw)
    bound = BF16_DD_ERR_BOUND + BF16_DD_ERR_REBAL_COEF * 13 ** 0.5
    assert np.abs(np.asarray(d_b) - np.asarray(d_p)).max() < bound


def test_hedged_frontier_kernel_path_matches_search_semantics(interpret_kernels):
    """drawdown_frontier_search(hedge=..., use_pallas=True) with kernels
    interpreted runs the hedged KERNEL path end-to-end (incl. the bf16
    rescore loop) and its optimum satisfies the budget with exact f32
    metrics."""
    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    prot = HedgeSpec.build(
        {0: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, 97.0, 0.5, 1.0)])}, NAMES)
    r = drawdown_frontier_search(
        jax.random.key(6), p, dd_budget=0.4, n_candidates=64, n_paths=512,
        n_steps=13, use_pallas=True, hedge=prot,
        score_dtype="bfloat16", rescore_top=8)
    assert r.opt_idx >= 0
    assert r.dd_p95[r.opt_idx] >= -0.4
    # lax path on the same key finds a consistent (same-law) optimum
    r_lax = drawdown_frontier_search(
        jax.random.key(6), p, dd_budget=0.4, n_candidates=64, n_paths=512,
        n_steps=13, use_pallas=False, hedge=prot)
    assert r_lax.opt_idx >= 0


def test_sharded_frontier_hedged_identity_bit_equal(eight_devices):
    from jax.sharding import Mesh

    from mcport.parallel.sharded_engines import sharded_simulated_frontier

    p = _params()
    mesh = Mesh(np.array(eight_devices), ("cand",))
    kw = dict(n_candidates=512, n_paths=1024, n_steps=13, mesh=mesh,
              objective="cvar")
    w0, m0 = sharded_simulated_frontier(
        jax.random.key(1), p.mean_step, p.chol_step,
        np.zeros(A), np.ones(A), **kw)
    w1, m1 = sharded_simulated_frontier(
        jax.random.key(1), p.mean_step, p.chol_step,
        np.zeros(A), np.ones(A),
        hedge_args=(np.ones(A), *IDENTITY.arrays), **kw)
    np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
    assert float(m0) == float(m1)


def test_hedged_mesh_full_option_surface(eight_devices, tmp_path):
    """gbm_risk(mesh=..., legs_by_asset=...) routes checkpoint/student_t/
    antithetic through the sharded RESUMABLE engine (bit-identical block grid
    to the single-chip hedged engine); qmc+mesh refuses for all engines."""
    import dataclasses

    from jax.sharding import Mesh

    from mcport.api import gbm_risk

    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    mesh = Mesh(np.array(eight_devices), ("paths",))
    legs = {0: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                               (LegType.BUY_PUT, 95.0, 0.5, 1.0)])}
    w = np.full(A, 0.25)
    base = Config(gbm=GBMConfig(n_paths=8192, path_block=1024, n_steps=4,
                                use_pallas=False))

    # qmc + mesh refuses (hedged or not)
    qcfg = Config(gbm=dataclasses.replace(base.gbm, qmc="sobol"))
    with pytest.raises(ValueError, match="qmc"):
        gbm_risk(p, w, qcfg, mesh=mesh, legs_by_asset=legs)
    with pytest.raises(ValueError, match="qmc"):
        gbm_risk(p, w, qcfg, mesh=mesh)

    # hedged + mesh + checkpoint: resumable route, bit-identical to the
    # single-chip hedged engine on the same block grid
    single = gbm_risk(p, w, base, legs_by_asset=legs)
    sharded = gbm_risk(p, w, base, mesh=mesh, legs_by_asset=legs,
                       checkpoint_path=str(tmp_path / "ck.npz"))
    assert sharded.var == single.var and sharded.cvar == single.cvar

    # hedged + mesh + student_t/antithetic run through the same route
    for field, val in (("innovations", "student_t"), ("antithetic", True)):
        cfg = Config(gbm=dataclasses.replace(base.gbm, **{field: val}))
        rep = gbm_risk(p, w, cfg, mesh=mesh, legs_by_asset=legs,
                       checkpoint_path=str(tmp_path / f"ck_{field}.npz"))
        assert np.isfinite([rep.var, rep.cvar]).all()

    # the plain one-shot form still runs
    rep = gbm_risk(p, w, base, mesh=mesh, legs_by_asset=legs)
    assert np.isfinite([rep.var, rep.cvar]).all()


def test_sharded_frontier_2d_hedged_identity_bit_equal(eight_devices):
    from jax.sharding import Mesh

    from mcport.parallel.sharded_engines import sharded_simulated_frontier_2d

    p = _params()
    mesh = Mesh(np.array(eight_devices).reshape(4, 2), ("paths", "cand"))
    kw = dict(n_candidates=64, n_paths=512, n_steps=13, mesh=mesh,
              objective="cvar")
    w0, m0 = sharded_simulated_frontier_2d(
        jax.random.key(2), p.mean_step, p.chol_step,
        np.zeros(A), np.ones(A), **kw)
    w1, m1 = sharded_simulated_frontier_2d(
        jax.random.key(2), p.mean_step, p.chol_step,
        np.zeros(A), np.ones(A),
        hedge_args=(np.ones(A), *IDENTITY.arrays), **kw)
    np.testing.assert_array_equal(np.asarray(w0), np.asarray(w1))
    # same winner; metric may differ by the hedged sketch's bin geometry
    assert np.isfinite(float(m1))


def test_hedged_kernel_unroll_same_stream():
    """Hedged settlement mode consumes the identical draw stream in the
    kernel and in its plain-jnp twin: even/odd step counts (the odd count
    takes the paired step loop's single-draw tail), protective-put legs."""
    from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

    p = _params(s0=[100.0, 50.0, 20.0, 8.0])
    mean = jnp.asarray(p.mean_step, jnp.float32)
    chol = jnp.asarray(p.chol_step, jnp.float32)
    w = np.asarray(jax.random.dirichlet(jax.random.key(2), jnp.ones(A), (8,)),
                   np.float32)
    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(p.s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(A)}, NAMES)
    args = _spec_args(prot, p.s0)
    for steps in (9, 12):
        kern = gbm_multi_portfolio_dd(17, mean, chol, w, 256, steps,
                                      hedge_args=args, interpret=True, block=128)
        twin = gbm_multi_portfolio_dd(17, mean, chol, w, 256, steps,
                                      hedge_args=args, reference=True, block=128)
        for k, t in zip(kern, twin):
            np.testing.assert_allclose(np.asarray(k), np.asarray(t), atol=2e-6)


def test_api_hedged_tail_risk_dcc_jump(weekly_data):
    """hedged_tail_risk's terminal composition covers the dcc and jump
    families too (late round 3) — all six model families hedge."""
    from mcport.api import hedged_tail_risk

    data = weekly_data
    legs = {data.names[0]: Legs.from_rows(
        [(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
         (LegType.BUY_PUT, float(data.prices[-1, 0]) * 0.95, 0.0, 1.0)])}
    cfg = Config(gbm=GBMConfig(n_paths=4096, path_block=4096, n_steps=13,
                               use_pallas=False))
    for model in ("dcc", "jump"):
        out = hedged_tail_risk(data, None, cfg, legs, model=model)
        assert out["cvar"] <= out["var"]
        assert out["hedged_assets"] == [data.names[0]]
        assert out["model"] == model
