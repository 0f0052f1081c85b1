"""The compiled Triton kernels on a GPU, at real widths.

Run: ``MCPORT_GPU=1 python -m pytest tests/test_gpu_kernels.py -m gpu -o
addopts=`` on a machine with a GPU (one process: ``-o addopts=`` drops the
default pytest-xdist workers, which could not share the card; ``chip_smoke.py``
runs it in-process); every test skips elsewhere through the ``gpu`` fixture.

What interpret mode cannot show: the kernels as Triton compiles them, at the
main path's widths. "Same draws" compares each kernel with its plain-jnp twin
(the same Threefry counters and the same per-block function, compiled by XLA)
under ``jax.default_matmul_precision("highest")``; "law" compares a kernel
with the lax engine, whose draws come from ``jax.random`` and so differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcport.ops import pallas_gbm as pg
from mcport.ops.pallas_multi_dd import BF16_DD_ERR_BOUND, gbm_multi_portfolio_dd

pytestmark = pytest.mark.gpu

N_PATHS, N_STEPS = 1 << 20, 252          # the path-risk / terminal block width
DD_CANDIDATES, DD_PATHS = 256, 131_072   # the dd-frontier width


def _market(a: int, rho: float = 0.5, scale: float = 0.01, seed: int = 0):
    rng = np.random.default_rng(seed)
    corr = (1 - rho) * np.eye(a) + rho
    chol = np.linalg.cholesky(scale**2 * corr).astype(np.float32)
    mean = rng.normal(3e-4, 2e-4, a).astype(np.float32)
    w = rng.dirichlet(np.ones(a)).astype(np.float32)
    return mean, chol, w


def _maxabs(x, y) -> float:
    return float(jnp.max(jnp.abs(x - y)))


# ---- same draws, real widths --------------------------------------------------
#
# Both sides run the same float32 operations on the same bits; what differs is
# the compiler (Triton against XLA): FMA contraction and the summation order of
# the 16-term correlate. Over 252 accumulated steps that stays near 1e-7
# (terminal) and 1e-6 (drawdown ratios), so 1e-5 holds with room.


def test_terminal_same_draws(gpu):
    _, chol, _ = _market(15)
    with jax.default_matmul_precision("highest"):
        got = pg.gbm_terminal_noise(jnp.int32(7), chol, N_PATHS, N_STEPS)
        want = pg.terminal_noise_reference(jnp.int32(7), chol, N_PATHS, N_STEPS)
    assert got.shape == want.shape == (16, N_PATHS)
    assert _maxabs(got, want) < 1e-5


@pytest.mark.parametrize("rebalance", [False, True])
def test_path_stats_same_draws(gpu, rebalance):
    mean, chol, w = _market(15)
    with jax.default_matmul_precision("highest"):
        got = pg.gbm_path_stats(jnp.int32(7), mean, chol, w, N_PATHS, N_STEPS,
                                rebalance=rebalance)
        want = pg.path_stats_reference(jnp.int32(7), mean, chol, w, N_PATHS,
                                       N_STEPS, rebalance=rebalance)
    for x, y in zip(got, want):
        assert bool(jnp.isfinite(x).all())
        assert _maxabs(x, y) < 1e-5


def test_multi_dd_same_draws(gpu):
    mean, chol, _ = _market(15)
    cands = np.random.default_rng(1).dirichlet(
        np.ones(15), size=DD_CANDIDATES).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        got = gbm_multi_portfolio_dd(jnp.int32(7), mean, chol, cands, DD_PATHS,
                                     N_STEPS)
        want = gbm_multi_portfolio_dd(jnp.int32(7), mean, chol, cands, DD_PATHS,
                                      N_STEPS, reference=True)
    for x, y in zip(got, want):
        assert x.shape == (DD_CANDIDATES, DD_PATHS)
        assert _maxabs(x, y) < 1e-5


# ---- the generator and the draws ----------------------------------------------


def test_normal_law(gpu):
    """Threefry bits -> uniforms -> polynomial Box-Muller are N(0, 1): with an
    identity factor, noise / sqrt(S) has unit normal moments."""
    a, n, steps = 16, 262_144, 16
    noise = pg.gbm_terminal_noise(jnp.int32(3), np.eye(a, dtype=np.float32),
                                  n, steps)
    z = noise / np.sqrt(steps)
    m = a * n
    assert abs(float(jnp.mean(z))) < 5 / np.sqrt(m)
    assert abs(float(jnp.mean(z * z)) - 1.0) < 8 / np.sqrt(m)
    assert abs(float(jnp.mean(z**3))) < 12 / np.sqrt(m)
    assert abs(float(jnp.mean(z**4)) - 3.0) < 40 / np.sqrt(m)


def test_streams_reproducible_and_distinct(gpu):
    _, chol, _ = _market(8)
    x1 = pg.gbm_terminal_noise(jnp.int32(7), chol, 4096, 4)
    x2 = pg.gbm_terminal_noise(jnp.int32(7), chol, 4096, 4)
    x3 = pg.gbm_terminal_noise(jnp.int32(8), chol, 4096, 4)
    assert bool(jnp.array_equal(x1, x2))
    assert not bool(jnp.array_equal(x1, x3))
    assert not bool(jnp.array_equal(x1[:, :128], x1[:, 128:256]))


@pytest.mark.parametrize("a", [15, 64])
def test_terminal_law_vs_lax(gpu, a):
    """Kernel and lax terminal log returns share their law: mean and
    covariance within Monte Carlo error of S * (m, L L')."""
    from mcport.models.gbm import terminal_log_returns

    steps, n = 8, 131_072
    mean, chol, _ = _market(a, rho=0.4, scale=0.02)
    term_k = pg.pallas_terminal_log_returns(jnp.int32(11), mean, chol, n, steps)
    term_l = terminal_log_returns(jax.random.key(0), mean, chol, n, steps)
    cov_true = steps * (chol.astype(np.float64) @ chol.T)
    tol_mu = 6 * np.sqrt(np.diag(cov_true)).max() / np.sqrt(n)
    tol_cov = 10 * cov_true.max() / np.sqrt(n)
    for term in (term_k, term_l):
        mu = jnp.mean(term, axis=0)
        xc = term - mu
        cov = np.asarray((xc.T @ xc) / (n - 1))
        assert float(jnp.max(jnp.abs(mu - steps * mean))) < tol_mu
        assert np.abs(cov - cov_true).max() < tol_cov


def test_antithetic_mirror_exact(gpu):
    mean, chol, _ = _market(15)
    n, steps = 8192, 8
    term = pg.pallas_terminal_log_returns(jnp.int32(5), mean, chol, n, steps,
                                          antithetic=True)
    mirror = term[: n // 2] + term[n // 2:]
    assert _maxabs(mirror, 2 * steps * mean) < 1e-5


def test_student_t_law(gpu):
    """Polar-t draws: the covariance is S * L L' (unit-variance shocks) and
    the tails are fat: 8-step sums of t(5.5) draws have excess kurtosis
    6 / (df - 4) / steps = 0.5."""
    a, n, steps, df = 15, 262_144, 8, 5.5
    mean, chol, _ = _market(a, rho=0.4, scale=0.02)
    term = pg.pallas_terminal_log_returns(jnp.int32(3), mean, chol, n, steps,
                                          t_df=df)
    cov_true = steps * (chol.astype(np.float64) @ chol.T)
    assert float(jnp.max(jnp.abs(jnp.cov(term.T) / cov_true - 1))) < 0.05
    z = (term - jnp.mean(term, axis=0)) / jnp.std(term, axis=0)
    assert 3.1 < float(jnp.mean(z**4)) < 4.0


def test_path_stats_invariants(gpu):
    mean, chol, w = _market(15)
    n, steps = 65_536, 32
    term, port, dd = pg.gbm_path_stats(jnp.int32(13), mean, chol, w, n, steps)
    assert bool(jnp.all(dd <= 1e-7)) and bool(jnp.all(dd >= -1.0))
    assert bool(jnp.all(port > -1.0))
    # buy-and-hold: the terminal return is w'exp(terminal log price) - 1
    assert _maxabs((jnp.exp(term) * w).sum(axis=1) - 1.0, port) < 1e-5
    assert bool(jnp.all(dd <= jnp.maximum(port, 0.0) + 1e-6))


def test_multi_dd_bf16_within_bound(gpu):
    """bf16 candidate scoring: buy-and-hold terminal returns stay exact f32,
    drawdowns within the pinned screening bound."""
    mean, chol, _ = _market(15)
    cands = np.random.default_rng(2).dirichlet(np.ones(15), size=64).astype(
        np.float32)
    t32, d32 = gbm_multi_portfolio_dd(jnp.int32(4), mean, chol, cands, 16_384, 26)
    t16, d16 = gbm_multi_portfolio_dd(jnp.int32(4), mean, chol, cands, 16_384, 26,
                                      score_dtype="bfloat16")
    assert _maxabs(t16, t32) < 1e-6
    assert _maxabs(d16, d32) < BF16_DD_ERR_BOUND


# ---- engine law: kernel path against the lax path ------------------------------


def test_resumable_engine_law_vs_lax(gpu, fixtures_dir):
    """run_resumable_mc on the fixture universe: the kernel engine and the lax
    engine agree in law. Asset moments within 4 standard errors of their
    difference; VaR and CVaR within 4 bootstrap standard errors."""
    import dataclasses

    from mcport.config import DataConfig, GBMConfig
    from mcport.data import load_universe
    from mcport.engine.mc_engine import run_resumable_mc
    from mcport.models import estimate_gbm

    daily = sorted(p for p in fixtures_dir.glob("*.csv") if "Weekly" not in p.name)
    d = load_universe(paths=daily, config=DataConfig(period="D"))
    params = estimate_gbm(d.prices)
    w = np.full(d.n_assets, 1.0 / d.n_assets)
    cfg = GBMConfig(n_paths=4 << 20, path_block=1 << 20, n_steps=N_STEPS,
                    seed=3, ci_boot=200)
    kern, _ = run_resumable_mc(params, w, cfg)
    lax_, _ = run_resumable_mc(params, w,
                               dataclasses.replace(cfg, use_pallas=False))
    n = cfg.n_paths
    se = np.sqrt(2 * np.diag(lax_.cov) / n)
    assert (np.abs(kern.mean - lax_.mean) < 4 * se).all()
    var_se = np.hypot(kern.tail_ci["var_se"], lax_.tail_ci["var_se"])
    cvar_se = np.hypot(kern.tail_ci["cvar_se"], lax_.tail_ci["cvar_se"])
    assert abs(kern.var - lax_.var) < 4 * var_se
    assert abs(kern.cvar - lax_.cvar) < 4 * cvar_se
