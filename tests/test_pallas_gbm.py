"""Pallas GBM kernels vs the lax reference engine (interpret mode on CPU).

Distribution-level parity: the kernels draw their own in-kernel Threefry
stream (a different stream from jax.random), so tests compare moments and
quantiles against the lax reference and exact analytics; draw-for-draw
parity with the plain-jnp twins is in tests/test_kernel_twins.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.models.gbm import terminal_log_returns
from mcport.ops.pallas_gbm import gbm_path_stats, pallas_terminal_log_returns

A = 4
MEAN = np.array([0.001, 0.002, -0.0005, 0.0015])
CHOL = np.linalg.cholesky(
    0.0004 * (0.55 * np.eye(A) + 0.45 * np.ones((A, A)))
)
KW = dict(interpret=True, block=128)


def test_terminal_shape_and_padding():
    out = pallas_terminal_log_returns(0, MEAN, CHOL, n_paths=300, n_steps=5, **KW)
    assert out.shape == (300, A)
    assert np.isfinite(np.asarray(out)).all()


def test_terminal_moments_match_reference():
    n, steps = 20_000, 12
    got = np.asarray(pallas_terminal_log_returns(1, MEAN, CHOL, n, steps, **KW))
    ref = np.asarray(
        terminal_log_returns(jax.random.key(1), MEAN, CHOL, n, steps, dtype=jnp.float32)
    )
    want_mean = MEAN * steps
    want_cov = (CHOL @ CHOL.T) * steps
    se = np.sqrt(np.diag(want_cov) / n)
    np.testing.assert_allclose(got.mean(0), want_mean, atol=float(5 * se.max()))
    np.testing.assert_allclose(np.cov(got, rowvar=False), want_cov, rtol=0.1, atol=1e-5)
    # same law as the lax engine
    np.testing.assert_allclose(got.mean(0), ref.mean(0), atol=float(8 * se.max()))
    np.testing.assert_allclose(got.std(0), ref.std(0), rtol=0.05)


def test_terminal_odd_steps():
    got = np.asarray(pallas_terminal_log_returns(2, MEAN, CHOL, 10_000, 7, **KW))
    np.testing.assert_allclose(
        got.std(0), np.sqrt(np.diag(CHOL @ CHOL.T) * 7), rtol=0.08
    )


def test_terminal_antithetic_mirror():
    n, steps = 256, 6
    out = np.asarray(
        pallas_terminal_log_returns(3, MEAN, CHOL, n, steps, antithetic=True, **KW)
    )
    drift = MEAN * steps
    # second half mirrors the first half's noise exactly
    np.testing.assert_allclose(
        out[: n // 2] - drift, -(out[n // 2 :] - drift), atol=1e-6
    )


def test_blocks_are_independent_streams():
    out = np.asarray(pallas_terminal_log_returns(4, MEAN, CHOL, 256, 4, **KW))
    b0, b1 = out[:128], out[128:]
    assert not np.allclose(b0, b1)
    # determinism: same seed → identical result
    again = np.asarray(pallas_terminal_log_returns(4, MEAN, CHOL, 256, 4, **KW))
    np.testing.assert_array_equal(out, again)


def test_path_stats_portfolio_consistency():
    n, steps = 4_000, 10
    w = np.array([0.4, 0.3, 0.2, 0.1])
    term, port, dd = gbm_path_stats(5, MEAN, CHOL, w, n, steps, **KW)
    term, port, dd = np.asarray(term), np.asarray(port), np.asarray(dd)
    assert term.shape == (n, A) and port.shape == (n,) and dd.shape == (n,)
    # portfolio terminal return recomputed from terminal log prices
    want_port = (np.exp(term) * w).sum(1) - 1.0
    np.testing.assert_allclose(port, want_port, atol=1e-5)
    # drawdown bounds: in [-1, 0], and <= terminal-implied drawdown
    assert (dd <= 1e-6).all() and (dd >= -1.0).all()
    # a path whose terminal value sits below peak must have dd <= V_T/peak - 1 <= V_T - 1
    neg = want_port < 0
    assert (dd[neg] <= want_port[neg] + 1e-5).all()


def test_path_stats_moments():
    n, steps = 20_000, 8
    w = np.full(A, 0.25)
    term, _, _ = gbm_path_stats(6, MEAN, CHOL, w, n, steps, **KW)
    term = np.asarray(term)
    want_cov = (CHOL @ CHOL.T) * steps
    se = np.sqrt(np.diag(want_cov) / n)
    np.testing.assert_allclose(term.mean(0), MEAN * steps, atol=float(5 * se.max()))
    np.testing.assert_allclose(np.cov(term, rowvar=False), want_cov, rtol=0.1, atol=1e-5)


def test_path_stats_zero_vol_drawdown():
    """Deterministic sanity: zero volatility → V_t monotone in sign(m), dd known."""
    m = np.array([-0.01, -0.01, -0.01, -0.01])
    chol0 = np.zeros((A, A))
    w = np.full(A, 0.25)
    steps = 5
    term, port, dd = gbm_path_stats(7, m, chol0, w, 64, steps, **KW)
    want_v = np.exp(-0.01 * steps)
    np.testing.assert_allclose(np.asarray(port), want_v - 1.0, atol=1e-6)
    # strictly decreasing value → max drawdown is terminal vs initial peak 1
    np.testing.assert_allclose(np.asarray(dd), want_v - 1.0, atol=1e-6)


def test_wide_universe_padding():
    """A > 16 pads to the next power of two — 64 assets, no layout bugs."""
    a = 64
    rng = np.random.default_rng(a)
    corr = 0.4 * np.eye(a) + 0.6
    chol = np.linalg.cholesky(0.0004 * corr).astype(np.float32)
    mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
    out = np.asarray(pallas_terminal_log_returns(0, mean, chol, 4_000, 8, **KW))
    assert out.shape == (4_000, a)
    want_sd = np.sqrt(np.diag(chol @ chol.T) * 8)
    np.testing.assert_allclose(out.std(0), want_sd, rtol=0.12)


# ---- polynomial Box-Muller variants (roofline work, r2) -------------------------

def test_poly_helpers_match_reference_math():
    """_ln_poly/_sincos_poly/_exp_poly vs numpy over their domains."""
    from mcport.ops.pallas_gbm import _exp_poly, _ln_poly, _sincos_poly

    rng = np.random.default_rng(0)
    u = rng.uniform(2**-23, 1.0, 100_000).astype(np.float32)
    assert np.max(np.abs(np.asarray(_ln_poly(jnp.asarray(u)))
                         - np.log(u.astype(np.float64)))) < 2e-6
    u2 = rng.uniform(0, 1, 100_000).astype(np.float32)
    c, s = _sincos_poly(jnp.asarray(u2))
    th = 2 * np.pi * u2.astype(np.float64)
    assert np.max(np.abs(np.asarray(c) - np.cos(th))) < 2e-7
    assert np.max(np.abs(np.asarray(s) - np.sin(th))) < 2e-7
    x = rng.uniform(-25, 10, 100_000).astype(np.float32)
    rel = np.abs(np.asarray(_exp_poly(jnp.asarray(x))).astype(np.float64)
                 / np.exp(x.astype(np.float64)) - 1)
    assert rel.max() < 5e-6


def test_poly_boxmuller_matches_exact_per_draw():
    """Same uniforms through poly and exact Box-Muller → same normals to ~2e-6
    absolute (the polynomial form changes throughput, not the distribution)."""
    from mcport.ops.pallas_gbm import _boxmuller, _boxmuller_poly

    rng = np.random.default_rng(1)
    u1 = rng.uniform(2**-23, 1.0, 200_000).astype(np.float32)
    u2 = rng.uniform(0, 1, 200_000).astype(np.float32)
    z1e, z2e = _boxmuller(jnp.asarray(u1), jnp.asarray(u2))
    z1, z2 = _boxmuller_poly(jnp.asarray(u1), jnp.asarray(u2))
    assert float(jnp.max(jnp.abs(z1 - z1e))) < 3e-6
    assert float(jnp.max(jnp.abs(z2 - z2e))) < 3e-6


def test_terminal_kernel_variants_same_law_interpret():
    """Both bm tiers read the same uniforms, so their noise sums differ only
    by the screening fits' draw error (summed over 8 steps)."""
    from mcport.ops.pallas_gbm import gbm_terminal_noise

    chol = np.diag([0.02, 0.03]).astype(np.float32)
    poly = np.asarray(gbm_terminal_noise(3, chol, 2048, 8, interpret=True, bm="poly"))
    fast = np.asarray(gbm_terminal_noise(3, chol, 2048, 8, interpret=True,
                                         bm="poly_fast"))
    np.testing.assert_allclose(fast, poly, atol=3e-4)


def test_poly_fast_fidelity_bound():
    """Screening tier (VERDICT r3 item 3): the measured draw-fidelity bound.

    Same uniforms through poly_fast and exact Box-Muller: the z error is the
    ln-fit error (5.7e-6) amplified by 1/r near u1→1, plus the sincos fit
    error (2.2e-5 cos / 2.5e-6 sin) scaled UP by r. Worst case over the full
    representable uniform range: ~1.5e-4 at the 5.65σ radius (u1 = 2^-23) —
    tiny relative to MC noise at any screening path count."""
    from mcport.ops.pallas_gbm import _boxmuller, _boxmuller_poly_fast

    rng = np.random.default_rng(1)
    # include extreme corners of both uniforms: deep tail and r→0
    u1 = np.concatenate([
        rng.uniform(2**-23, 1.0, 400_000),
        np.array([2**-23, 1e-6, 0.9999, 0.999999, 1.0 - 2**-24]),
    ]).astype(np.float32)
    u2 = rng.uniform(0, 1, u1.shape[0]).astype(np.float32)
    z1e, z2e = _boxmuller(jnp.asarray(u1), jnp.asarray(u2))
    z1f, z2f = _boxmuller_poly_fast(jnp.asarray(u1), jnp.asarray(u2))
    d1 = np.abs(np.asarray(z1f) - np.asarray(z1e))
    d2 = np.abs(np.asarray(z2f) - np.asarray(z2e))
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    # ln err / r (dominates small r) + sincos err * r (dominates the tail)
    bound = 1e-5 + 2.5e-5 * r + 1.2 * 5.7e-6 / np.maximum(r, 1e-3)
    assert (d1 <= bound).all() and (d2 <= bound).all()
    assert d1.max() < 1.6e-4 and d2.max() < 1.6e-4
    # distribution-level: quantiles of the fast tier match exact to 1e-4
    for q in (0.001, 0.01, 0.5, 0.99, 0.999):
        assert abs(np.quantile(np.asarray(z1f), q)
                   - np.quantile(np.asarray(z1e), q)) < 1e-4


def test_t_kernel_law_parity_vs_lax_t():
    """Pallas t mode vs the lax polar-t engine: same law (different streams)."""
    from mcport.models.gbm import terminal_log_returns_t
    from mcport.ops.pallas_gbm import pallas_terminal_log_returns

    a, n, steps, df = 3, 65_536, 8, 5.5
    m = np.full(a, 0.001, np.float32)
    chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
    kern = np.asarray(pallas_terminal_log_returns(
        3, m, chol, n, steps, interpret=True, t_df=df)).astype(np.float64)
    lax_t = np.asarray(terminal_log_returns_t(
        jax.random.key(1), m, chol, df, n, steps, dtype=jnp.float64))
    cov_true = steps * (chol @ chol.T).astype(np.float64)
    se = np.sqrt(np.diag(cov_true) / n)
    assert np.all(np.abs(kern.mean(0) - lax_t.mean(0)) < 8 * se)
    np.testing.assert_allclose(np.cov(kern, rowvar=False), cov_true, rtol=0.06)
    # fat tails present in both (pooled standardized kurtosis above normal's 3)
    zk = (kern - kern.mean(0)) / kern.std(0)
    zl = (lax_t - lax_t.mean(0)) / lax_t.std(0)
    assert np.mean(zk**4) > 3.2 and np.mean(zl**4) > 3.2
    assert abs(np.mean(zk**4) - np.mean(zl**4)) < 0.6


def test_asset_axis_padding_guard():
    """Guard for the A = 31/63/127 bench sizes (benchmarks/bench_scaling.py):
    odd widths one below a power of two must pad cleanly in BOTH kernels
    — terminal stds match the factor diagonal, and path-stats' portfolio
    terminal equals the weighted exp of its own per-asset terminals (padding
    rows contribute exactly zero through the weight vector)."""
    for a in (31, 63):
        rng = np.random.default_rng(a)
        corr = 0.4 * np.eye(a) + 0.6
        chol = np.linalg.cholesky(0.0004 * corr).astype(np.float32)
        mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
        w = rng.dirichlet(np.ones(a)).astype(np.float32)
        term, port, dd = gbm_path_stats(0, mean, chol, w, 512, 6, **KW)
        term, port, dd = map(np.asarray, (term, port, dd))
        assert term.shape == (512, a)
        np.testing.assert_allclose(
            port, (np.exp(term) @ w) - 1.0, atol=5e-6)
        assert (dd <= 0).all() and (dd >= -1).all()
        out = np.asarray(pallas_terminal_log_returns(0, mean, chol, 4_000, 8, **KW))
        want_sd = np.sqrt(np.diag(chol @ chol.T) * 8)
        np.testing.assert_allclose(out.std(0), want_sd, rtol=0.15)
