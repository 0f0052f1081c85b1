"""Multi-portfolio drawdown kernel + drawdown-constrained frontier search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.engine.drawdown_frontier import _lax_multi_dd, drawdown_frontier_search
from mcport.models.gbm import GBMParams
from mcport.ops.pallas_gbm import gbm_path_stats
from mcport.ops.pallas_multi_dd import (
    BF16_DD_ERR_BOUND,
    BF16_DD_ERR_REBAL_COEF,
    gbm_multi_portfolio_dd,
)

A = 3
MEAN = np.array([0.002, 0.001, 0.0015], np.float32)
CHOL = np.linalg.cholesky(0.0009 * (0.6 * np.eye(A) + 0.4)).astype(np.float32)
PARAMS = GBMParams(s0=np.ones(A) * 100, mean_step=MEAN, chol_step=CHOL)
KW = dict(interpret=True, block=128)


def test_single_candidate_matches_path_stats_kernel():
    """W=1 multi-portfolio kernel == the single-portfolio kernel: identical
    seed/program/iteration keys → identical draws in interpret mode."""
    w = np.array([[0.5, 0.3, 0.2]], np.float32)
    term_m, dd_m = gbm_multi_portfolio_dd(9, MEAN, CHOL, w, 512, 10, **KW)
    _, port_s, dd_s = gbm_path_stats(9, MEAN, CHOL, w[0], 512, 10, **KW)
    np.testing.assert_allclose(np.asarray(term_m[0]), np.asarray(port_s), atol=1e-5)
    np.testing.assert_allclose(np.asarray(dd_m[0]), np.asarray(dd_s), atol=1e-5)


def test_multi_candidates_consistent_with_lax_reference_distribution():
    w = np.asarray(jax.random.dirichlet(jax.random.key(0), jnp.ones(A), (16,)), np.float32)
    term, dd = gbm_multi_portfolio_dd(3, MEAN, CHOL, w, 4096, 12, **KW)
    term, dd = np.asarray(term), np.asarray(dd)
    ref_term, ref_dd = map(np.asarray, _lax_multi_dd(
        jax.random.key(7), jnp.asarray(MEAN), jnp.asarray(CHOL),
        jnp.asarray(w), 4096, 12, jnp.float32))
    # same law: per-candidate means agree within MC error
    se = term.std(1).max() / np.sqrt(4096)
    np.testing.assert_allclose(term.mean(1), ref_term.mean(1), atol=float(6 * se))
    np.testing.assert_allclose(dd.mean(1), ref_dd.mean(1), atol=0.02)
    assert (dd <= 1e-6).all() and (dd >= -1).all()


def test_zero_vol_multi_dd_closed_form():
    w = np.array([[1.0, 0.0, 0.0], [0.25, 0.25, 0.5]], np.float32)
    m = np.full(A, -0.01, np.float32)
    term, dd = gbm_multi_portfolio_dd(1, m, np.zeros((A, A), np.float32), w, 64, 5, **KW)
    want = np.exp(-0.01 * 5) - 1.0
    np.testing.assert_allclose(np.asarray(term), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dd), want, atol=1e-6)


def test_frontier_search_feasibility_logic():
    r = drawdown_frontier_search(
        jax.random.key(0), PARAMS, dd_budget=0.15,
        n_candidates=256, n_paths=2048, n_steps=32, w_block=64, dtype=jnp.float64,
    )
    assert r.weights.shape == (256, A)
    if r.opt_idx >= 0:
        assert r.feasible[r.opt_idx]
        assert r.dd_p95[r.opt_idx] >= -0.15 - 1e-9
        # optimal = max return among feasible
        assert r.ret[r.opt_idx] == pytest.approx(r.ret[r.feasible].max())
        # unconstrained max return should be >= the constrained one
        assert r.ret[r.valid].max() >= r.ret[r.opt_idx] - 1e-12


def test_frontier_infeasible_budget():
    r = drawdown_frontier_search(
        jax.random.key(1), PARAMS, dd_budget=0.0001,  # nothing survives
        n_candidates=64, n_paths=1024, n_steps=32, w_block=64, dtype=jnp.float64,
    )
    assert not r.feasible.any() and r.opt_idx == -1 and r.opt_weights is None


def test_tighter_budget_never_increases_return():
    loose = drawdown_frontier_search(
        jax.random.key(2), PARAMS, dd_budget=0.5,
        n_candidates=256, n_paths=2048, n_steps=32, w_block=64, dtype=jnp.float64,
    )
    tight = drawdown_frontier_search(
        jax.random.key(2), PARAMS, dd_budget=0.1,
        n_candidates=256, n_paths=2048, n_steps=32, w_block=64, dtype=jnp.float64,
    )
    if loose.opt_idx >= 0 and tight.opt_idx >= 0:
        assert loose.ret[loose.opt_idx] >= tight.ret[tight.opt_idx] - 1e-12


def test_multi_dd_bf16_scoring_fidelity():
    """score_dtype="bfloat16" leaves terminal returns bit-exact (terminal dot
    is always f32 from the exact asset state) and perturbs drawdowns by at
    most ~bf16 operand rounding — far below per-candidate MC noise."""
    w = np.asarray(jax.random.dirichlet(jax.random.key(1), jnp.ones(A), (16,)),
                   np.float32)
    f32 = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 2048, 13, **KW)
    b16 = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 2048, 13,
                                 score_dtype="bfloat16", **KW)
    assert (np.asarray(f32[0]) == np.asarray(b16[0])).all()
    dd_err = np.abs(np.asarray(f32[1]) - np.asarray(b16[1]))
    assert dd_err.max() < BF16_DD_ERR_BOUND
    # per-candidate mean drawdown (the screening statistic) barely moves
    assert np.abs(np.asarray(f32[1]).mean(1) - np.asarray(b16[1]).mean(1)).max() < 2e-3


def test_frontier_bf16_screen_exact_rescore(interpret_kernels):
    """bf16 screening + f32 top-candidate rescore finds the same optimum as a
    full-f32 search, with bit-exact reported metrics at the optimum (same
    seed → same paths; the rescore re-derives them at f32)."""
    kw = dict(dd_budget=0.35, n_candidates=64, n_paths=2048, n_steps=26,
              use_pallas=True)
    r32 = drawdown_frontier_search(jax.random.key(2), PARAMS, **kw)
    rb16 = drawdown_frontier_search(jax.random.key(2), PARAMS,
                                    score_dtype="bfloat16", **kw)
    assert r32.opt_idx >= 0
    assert rb16.opt_idx == r32.opt_idx
    assert rb16.ret[rb16.opt_idx] == r32.ret[r32.opt_idx]
    assert rb16.dd_p95[rb16.opt_idx] == r32.dd_p95[r32.opt_idx]


def test_frontier_auto_tier_default_bitequal_vs_f32(interpret_kernels):
    """Round-4 default: score_dtype="auto" resolves to the bf16 screen +
    exact rescore on big buy-and-hold kernel workloads, and the reported
    optimum is BIT-EQUAL to a full-f32 search (identity + metrics)."""
    kw = dict(dd_budget=0.35, n_candidates=64, n_paths=2048, n_steps=26,
              use_pallas=True)
    r32 = drawdown_frontier_search(jax.random.key(2), PARAMS,
                                   score_dtype="float32", **kw)
    # auto_bf16_min_work=0 forces the auto heuristic ON at test scale
    rauto = drawdown_frontier_search(jax.random.key(2), PARAMS,
                                     auto_bf16_min_work=0, **kw)
    assert r32.opt_idx >= 0
    assert rauto.opt_idx == r32.opt_idx
    assert rauto.ret[rauto.opt_idx] == r32.ret[r32.opt_idx]
    assert rauto.dd_p95[rauto.opt_idx] == r32.dd_p95[r32.opt_idx]
    # below the work threshold (default 2^25 > 64*2048*26) auto stays f32:
    # every score matches the f32 run, not just the rescored optimum
    rsmall = drawdown_frontier_search(jax.random.key(2), PARAMS, **kw)
    np.testing.assert_array_equal(rsmall.ret, r32.ret)
    np.testing.assert_array_equal(rsmall.dd_p95, r32.dd_p95)
    # rebalanced scoring compounds bf16 into returns: auto must refuse bf16
    rreb = drawdown_frontier_search(
        jax.random.key(2), PARAMS, auto_bf16_min_work=0, rebalance=True, **kw)
    rreb32 = drawdown_frontier_search(
        jax.random.key(2), PARAMS, score_dtype="float32", rebalance=True, **kw)
    np.testing.assert_array_equal(rreb.ret, rreb32.ret)


def test_multi_dd_rebalance_matches_path_stats_kernel():
    """W=1 rebalanced multi-dd == the single-portfolio kernel's rebalance
    mode: identical streams, same V_{t+1} = V_t * w'exp(x_t) recursion."""
    w = np.array([[0.5, 0.3, 0.2]], np.float32)
    for steps in (9, 10):
        term_m, dd_m = gbm_multi_portfolio_dd(9, MEAN, CHOL, w, 512, steps,
                                              rebalance=True, **KW)
        _, port_s, dd_s = gbm_path_stats(9, MEAN, CHOL, w[0], 512, steps,
                                         rebalance=True, **KW)
        np.testing.assert_allclose(np.asarray(term_m[0]), np.asarray(port_s), atol=1e-5)
        np.testing.assert_allclose(np.asarray(dd_m[0]), np.asarray(dd_s), atol=1e-5)


def test_multi_dd_rebalance_law_vs_lax():
    """Rebalanced kernel scores agree in law with the lax cumprod reference."""
    w = np.asarray(jax.random.dirichlet(jax.random.key(0), jnp.ones(A), (8,)), np.float32)
    term, dd = gbm_multi_portfolio_dd(3, MEAN, CHOL, w, 4096, 12,
                                      rebalance=True, **KW)
    ref_term, ref_dd = map(np.asarray, _lax_multi_dd(
        jax.random.key(7), jnp.asarray(MEAN), jnp.asarray(CHOL),
        jnp.asarray(w), 4096, 12, jnp.float32, True))
    term, dd = np.asarray(term), np.asarray(dd)
    se = term.std(1).max() / np.sqrt(4096)
    np.testing.assert_allclose(term.mean(1), ref_term.mean(1), atol=float(6 * se))
    np.testing.assert_allclose(dd.mean(1), ref_dd.mean(1), atol=0.02)
    assert (dd <= 1e-6).all() and (dd >= -1).all()


def test_frontier_rebalance_mode(interpret_kernels):
    """Rebalanced search runs end-to-end on the kernel path and differs from
    buy-and-hold scoring (single-asset candidates aside, the metrics move)."""
    kw = dict(dd_budget=0.35, n_candidates=64, n_paths=2048, n_steps=26,
              use_pallas=True)
    rb = drawdown_frontier_search(jax.random.key(2), PARAMS, rebalance=True, **kw)
    bh = drawdown_frontier_search(jax.random.key(2), PARAMS, **kw)
    assert rb.opt_idx >= 0
    assert not np.allclose(rb.ret, bh.ret)
    # rebalanced and buy-and-hold agree for near-single-asset candidates only;
    # the same candidate set is sampled (same key) either way
    np.testing.assert_array_equal(rb.weights, bh.weights)


def test_multi_dd_tf32_scoring_fidelity():
    """tensorfloat32 tier: terminal stays bit-exact (f32 terminal dot), dd
    within ~1e-4 of full f32 — the cheap near-exact middle tier."""
    w = np.asarray(jax.random.dirichlet(jax.random.key(3), jnp.ones(A), (16,)),
                   np.float32)
    f32 = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 2048, 13, **KW)
    tf32 = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 2048, 13,
                                  score_dtype="tensorfloat32", **KW)
    assert (np.asarray(f32[0]) == np.asarray(tf32[0])).all()
    assert np.abs(np.asarray(f32[1]) - np.asarray(tf32[1])).max() < 2e-4


def test_multi_dd_flag_matrix_composes():
    """Every score_dtype tier composes with rebalance and stays within its
    tier's documented error of the plain-f32 result."""
    w = np.asarray(jax.random.dirichlet(jax.random.key(5), jnp.ones(A), (8,)),
                   np.float32)
    for rebalance in (False, True):
        # bf16's per-path MAX error compounds in rebalance mode (~2e-3
        # relative per step as a random walk; the max over 8k samples sits
        # several sigma out) — the frontier's guarantee is unaffected since
        # the winner is always rescored at f32 (drawdown_frontier loop)
        tol = {"float32": 0.0, "tensorfloat32": 2e-4,
               "bfloat16": BF16_DD_ERR_BOUND + BF16_DD_ERR_REBAL_COEF * 13**0.5
               if rebalance else 1.5e-2}
        base = gbm_multi_portfolio_dd(11, MEAN, CHOL, w, 1024, 13,
                                      rebalance=rebalance, **KW)
        for sd in ("float32", "tensorfloat32", "bfloat16"):
            atol = tol[sd]
            term, dd = gbm_multi_portfolio_dd(
                11, MEAN, CHOL, w, 1024, 13,
                score_dtype=sd, rebalance=rebalance, **KW)
            if atol == 0.0:
                assert (np.asarray(term) == np.asarray(base[0])).all()
                assert (np.asarray(dd) == np.asarray(base[1])).all()
            else:
                assert np.abs(np.asarray(dd) - np.asarray(base[1])).max() < atol


# ---- model-family frontier (round 3): GARCH --------------------


def _family_history():
    rng = np.random.default_rng(21)
    return (rng.standard_t(6, (180, 4)) * 0.02 + 0.002).astype(np.float32)


def test_family_frontier_garch_sanity_and_chunk_invariance():
    import jax

    from mcport.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport.models.garch_mc import estimate_ccc_garch

    gp = estimate_ccc_garch(_family_history())
    kw = dict(dd_budget=0.30, n_candidates=96, n_paths=1024, n_steps=13)
    r = family_drawdown_frontier_search(jax.random.key(0), "garch", gp, **kw)
    assert r.opt_idx >= 0
    assert r.dd_p95[r.opt_idx] >= -0.30
    # opt maximizes return among the feasible set
    assert r.ret[r.opt_idx] == np.max(r.ret[r.feasible])
    # chunking must not change anything (shared per-chunk path stream)
    r2 = family_drawdown_frontier_search(jax.random.key(0), "garch", gp,
                                         w_block=32, **kw)
    np.testing.assert_array_equal(r.ret, r2.ret)
    np.testing.assert_array_equal(r.dd_p95, r2.dd_p95)
    assert r.opt_idx == r2.opt_idx
    # widening the budget can only improve the optimum
    r_wide = family_drawdown_frontier_search(jax.random.key(0), "garch", gp,
                                             **{**kw, "dd_budget": 0.60})
    assert r_wide.ret[r_wide.opt_idx] >= r.ret[r.opt_idx]


def test_family_frontier_hedged_and_errors():
    import jax

    from mcport.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport.models.garch_mc import estimate_ccc_garch
    from mcport.options import HedgeSpec, LegType, Legs

    h = _family_history()
    gp = estimate_ccc_garch(h)
    names = ["X0", "X1", "X2", "X3"]
    s0 = np.array([100.0, 50.0, 20.0, 8.0])
    prot = HedgeSpec.build(
        {i: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, float(s0[i]) * 0.98, 0.0, 1.0)])
         for i in range(4)}, names)
    kw = dict(dd_budget=0.25, n_candidates=64, n_paths=512, n_steps=13)
    base = family_drawdown_frontier_search(jax.random.key(2), "garch", gp, **kw)
    hedged = family_drawdown_frontier_search(jax.random.key(2), "garch", gp,
                                             hedge=prot, s0=s0, **kw)
    # zero-premium protective puts improve the dd distribution in aggregate
    assert hedged.dd_p95.mean() > base.dd_p95.mean()
    with pytest.raises(ValueError, match="model must be"):
        family_drawdown_frontier_search(jax.random.key(0), "nope", gp, **kw)
    with pytest.raises(ValueError, match="s0"):
        family_drawdown_frontier_search(jax.random.key(0), "garch", gp,
                                        hedge=prot, **kw)


def test_poly_fast_path_tier_and_stream_consistent_rescore(interpret_kernels):
    """bm="poly_fast" (round-4 screening tier) through the PATH tier.

    Interpret mode feeds the SAME Threefry uniforms to every bm variant, so
    the fast tier's scores sit within the draw-fidelity bound of the poly
    default (|Δz| <= ~1.5e-4 propagated through the step recursion), the
    single-portfolio path-stats kernel stays consistent with the W=1
    multi-dd kernel, and — the guarantee that matters — the bf16 screen's
    exact rescore runs on the SAME bm, so the reported optimum is bit-equal
    to a full-f32 poly_fast search (stream-consistent exactness)."""
    w = np.asarray(jax.random.dirichlet(jax.random.key(1), jnp.ones(A), (16,)),
                   np.float32)
    base = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 1024, 13, **KW)
    fast = gbm_multi_portfolio_dd(5, MEAN, CHOL, w, 1024, 13, bm="poly_fast",
                                  **KW)
    assert np.abs(np.asarray(base[0]) - np.asarray(fast[0])).max() < 2e-3
    assert np.abs(np.asarray(base[1]) - np.asarray(fast[1])).max() < 2e-3
    # single-portfolio path-stats kernel: same fast stream as multi-dd W=1
    _, port_s, dd_s = gbm_path_stats(5, MEAN, CHOL, w[0], 1024, 13,
                                     bm="poly_fast", **KW)
    np.testing.assert_allclose(np.asarray(fast[0][0]), np.asarray(port_s),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(fast[1][0]), np.asarray(dd_s),
                               atol=1e-5)

    kw = dict(dd_budget=0.35, n_candidates=64, n_paths=1024, n_steps=13,
              use_pallas=True, bm="poly_fast")
    rf32 = drawdown_frontier_search(jax.random.key(2), PARAMS,
                                    score_dtype="float32", **kw)
    rb16 = drawdown_frontier_search(jax.random.key(2), PARAMS,
                                    score_dtype="bfloat16", **kw)
    assert rf32.opt_idx >= 0
    assert rb16.opt_idx == rf32.opt_idx
    assert rb16.ret[rb16.opt_idx] == rf32.ret[rf32.opt_idx]
    assert rb16.dd_p95[rb16.opt_idx] == rf32.dd_p95[rf32.opt_idx]
