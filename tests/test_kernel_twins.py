"""The fused kernels' building blocks on the CPU: the in-kernel Threefry
generator against jax.random's, each kernel (interpret mode) against its
plain-jnp twin on the same draws, the wrappers' padding rules, and lowering
through the Pallas Triton route for the GPU (the step that a CPU-only
interpret run cannot reach)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng

from mcport.ops import dispatch
from mcport.ops import pallas_gbm as pg
from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd
from mcport.options import HedgeSpec, LegType, Legs


def _problem(a: int, seed: int = 0):
    rng = np.random.default_rng(seed + a)
    corr = 0.5 * np.eye(a) + 0.5
    chol = np.linalg.cholesky(4e-4 * corr).astype(np.float32)
    mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
    w = rng.dirichlet(np.ones(a)).astype(np.float32)
    cands = rng.dirichlet(np.ones(a), size=40).astype(np.float32)
    return mean, chol, w, cands


# ---- random bits -----------------------------------------------------------


@pytest.mark.parametrize("key,shape", [
    ((0, 0), (7,)),
    ((123, 456), (4, 33)),
    ((0xFFFFFFFF, 1), (16, 128)),
    ((2**31 + 5, 2**30), (3, 5, 7)),
])
def test_threefry_bit_exact_vs_jax(key, shape):
    """threefry2x32 == jax.random's threefry_2x32 on the same key/counters."""
    rng = np.random.default_rng(sum(shape))
    x0 = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(prng.threefry_2x32(
        jnp.asarray(key, jnp.uint32),
        jnp.concatenate([x0.ravel(), x1.ravel()])))
    y0, y1 = pg.threefry2x32(key[0], key[1], x0, x1)
    np.testing.assert_array_equal(np.concatenate([np.ravel(y0), np.ravel(y1)]),
                                  want)


def test_uniform_pair_range_and_independence():
    u1, u2 = pg.uniform_pair(7, 3, 11, (16, 2048))
    u1, u2 = np.asarray(u1), np.asarray(u2)
    assert (u1 > 0).all() and (u1 <= 1).all() and (u2 > 0).all() and (u2 <= 1).all()
    assert abs(u1.mean() - 0.5) < 0.01 and abs(np.corrcoef(u1.ravel(), u2.ravel())[0, 1]) < 0.02
    # a different block or draw index is a different stream
    assert not np.array_equal(u1, np.asarray(pg.uniform_pair(7, 4, 11, (16, 2048))[0]))
    assert not np.array_equal(u1, np.asarray(pg.uniform_pair(7, 3, 12, (16, 2048))[0]))


@pytest.mark.parametrize("a,want", [(1, 16), (15, 16), (16, 16), (17, 32), (31, 32), (64, 64)])
def test_asset_rows_pad_to_power_of_two(a, want):
    assert pg.a_pad_for(a) == want


# ---- same draws: kernel (interpret) vs plain-jnp twin ------------------------

# odd step counts exercise the single-draw tail, 300 paths a ragged last block
N_PATHS, N_STEPS = 300, 7


@pytest.mark.parametrize("a", [1, 15, 20, 31])
def test_terminal_kernel_matches_twin(a):
    _, chol, _, _ = _problem(a)
    got = pg.gbm_terminal_noise(3, chol, N_PATHS, N_STEPS, interpret=True)
    want = pg.terminal_noise_reference(3, chol, N_PATHS, N_STEPS)
    assert got.shape == want.shape == (pg.a_pad_for(a), 384)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("a", [1, 15, 20, 31])
def test_path_stats_kernel_matches_twin(a):
    mean, chol, w, _ = _problem(a)
    got = pg.gbm_path_stats(3, mean, chol, w, N_PATHS, N_STEPS, interpret=True)
    want = pg.path_stats_reference(3, mean, chol, w, N_PATHS, N_STEPS)
    assert got[0].shape == (N_PATHS, a) and got[1].shape == (N_PATHS,)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


@pytest.mark.parametrize("a", [1, 15, 20, 31])
def test_multi_dd_kernel_matches_twin(a):
    mean, chol, _, cands = _problem(a)
    got = gbm_multi_portfolio_dd(3, mean, chol, cands, N_PATHS, N_STEPS,
                                 interpret=True)
    want = gbm_multi_portfolio_dd(3, mean, chol, cands, N_PATHS, N_STEPS,
                                  reference=True)
    assert got[0].shape == (40, N_PATHS)
    for x, y in zip(got, want):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


def _hedge_args(a):
    names = [f"X{i}" for i in range(a)]
    s0 = np.full(a, 100.0, np.float32)
    spec = HedgeSpec.build(
        {0: Legs.from_rows([(LegType.BUY_ASSET, 0.0, 0.0, 1.0),
                            (LegType.BUY_PUT, 95.0, 1.0, 1.0),
                            (LegType.SELL_CALL, 110.0, 1.5, 1.0)])}, names)
    return (s0, *spec.arrays)


@pytest.mark.parametrize("mode", ["student_t", "rebalance", "hedged", "bfloat16"])
def test_multi_dd_modes_match_twin(mode):
    mean, chol, _, cands = _problem(5)
    kw = {"student_t": dict(t_df=5.0), "rebalance": dict(rebalance=True),
          "hedged": dict(hedge_args=_hedge_args(5)),
          "bfloat16": dict(score_dtype="bfloat16")}[mode]
    got = gbm_multi_portfolio_dd(5, mean, chol, cands, N_PATHS, N_STEPS,
                                 interpret=True, **kw)
    want = gbm_multi_portfolio_dd(5, mean, chol, cands, N_PATHS, N_STEPS,
                                  reference=True, **kw)
    for x, y in zip(got, want):
        assert np.isfinite(np.asarray(x)).all()
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


# ---- lowering through the Triton route ----------------------------------------

A15 = _problem(15)


def _lower_cases():
    mean, chol, w, cands = A15
    cands = np.tile(cands, (7, 1))[:256]
    hedge = _hedge_args(15)
    return {
        "terminal": lambda s: pg.gbm_terminal_noise(s, chol, 4096, 252),
        "terminal_fast": lambda s: pg.gbm_terminal_noise(s, chol, 4096, 252,
                                                         bm="poly_fast"),
        "terminal_t": lambda s: pg.gbm_terminal_noise(s, chol, 4096, 251, t_df=5.0),
        "path_stats": lambda s: pg.gbm_path_stats(s, mean, chol, w, 4096, 252),
        "path_stats_rebalance_t": lambda s: pg.gbm_path_stats(
            s, mean, chol, w, 4096, 251, rebalance=True, t_df=5.0),
        "multi_dd": lambda s: gbm_multi_portfolio_dd(s, mean, chol, cands, 4096, 252),
        "multi_dd_tf32": lambda s: gbm_multi_portfolio_dd(
            s, mean, chol, cands, 4096, 252, score_dtype="tensorfloat32"),
        "multi_dd_bf16": lambda s: gbm_multi_portfolio_dd(
            s, mean, chol, cands, 4096, 252, score_dtype="bfloat16"),
        "multi_dd_rebalance": lambda s: gbm_multi_portfolio_dd(
            s, mean, chol, cands, 4096, 252, rebalance=True),
        "multi_dd_hedged": lambda s: gbm_multi_portfolio_dd(
            s, mean, chol, cands, 4096, 252, hedge_args=hedge),
    }


@pytest.mark.parametrize("case", sorted(_lower_cases()))
def test_kernel_lowers_through_triton(case, monkeypatch):
    """Every kernel variant traces and lowers for CUDA through
    ``backend="triton"`` at a real width (what Pallas hands to Triton's
    compiler on the card)."""
    monkeypatch.setattr(dispatch, "_platform", lambda: "gpu")
    lowered = jax.jit(_lower_cases()[case]).trace(jnp.int32(1)).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
