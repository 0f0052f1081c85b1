"""Resumable MC engine: determinism, checkpoint round-trip, preemption equivalence."""

import numpy as np
import pytest

from mcport.config import GBMConfig, SketchConfig
from mcport.engine.mc_engine import load_checkpoint, run_resumable_mc
from mcport.models.gbm import GBMParams

A = 3
PARAMS = GBMParams(
    s0=np.array([100.0, 50.0, 20.0]),
    mean_step=np.array([0.001, 0.002, 0.0015]),
    chol_step=np.linalg.cholesky(0.0004 * (0.6 * np.eye(A) + 0.4)),
)
W = np.array([0.5, 0.3, 0.2])
CFG = GBMConfig(n_paths=8_192, n_steps=8, path_block=1_024, seed=5, use_pallas=False)
SKETCH = SketchConfig(n_bins=2048)


def test_full_run_stats():
    report, ck = run_resumable_mc(PARAMS, W, CFG, SKETCH)
    assert ck.done and report.n_paths == CFG.n_paths
    want_mean = PARAMS.mean_step * CFG.n_steps
    want_cov = (PARAMS.chol_step @ PARAMS.chol_step.T) * CFG.n_steps
    se = np.sqrt(np.diag(want_cov) / CFG.n_paths)
    np.testing.assert_allclose(report.mean, want_mean, atol=float(5 * se.max()))
    np.testing.assert_allclose(report.cov, want_cov, rtol=0.15, atol=1e-5)
    assert report.cvar <= report.var


def test_preemption_equivalence(tmp_path):
    """Blocks split across 3 calls (with a disk round-trip) == one uninterrupted run."""
    whole, _ = run_resumable_mc(PARAMS, W, CFG, SKETCH)

    path = tmp_path / "mc.npz"
    _, ck = run_resumable_mc(PARAMS, W, CFG, SKETCH, max_blocks=3, checkpoint_path=path)
    assert not ck.done and ck.next_block == 3
    ck2 = load_checkpoint(path)
    _, ck3 = run_resumable_mc(PARAMS, W, CFG, SKETCH, checkpoint=ck2, max_blocks=2,
                              checkpoint_path=path)
    assert ck3.next_block == 5
    resumed, ck4 = run_resumable_mc(PARAMS, W, CFG, SKETCH, checkpoint=load_checkpoint(path))
    assert ck4.done

    np.testing.assert_allclose(resumed.mean, whole.mean, atol=1e-6)
    np.testing.assert_allclose(resumed.cov, whole.cov, rtol=1e-5, atol=1e-8)
    assert resumed.var == pytest.approx(whole.var, abs=1e-9)
    assert resumed.cvar == pytest.approx(whole.cvar, abs=1e-9)
    assert resumed.port_mean == pytest.approx(whole.port_mean, abs=1e-7)
    assert resumed.n_paths == whole.n_paths


def test_wrong_config_checkpoint_rejected(tmp_path):
    path = tmp_path / "mc.npz"
    run_resumable_mc(PARAMS, W, CFG, SKETCH, max_blocks=1, checkpoint_path=path)
    other = GBMConfig(n_paths=8_192, n_steps=16, path_block=1_024, seed=5, use_pallas=False)
    with pytest.raises(ValueError):
        run_resumable_mc(PARAMS, W, other, SKETCH, checkpoint=load_checkpoint(path))


def test_fast_normal_tier_config():
    """bm="poly_fast" (round-4 screening tier) changes the checkpoint digest
    (stream-affecting) but old default-config digests are unchanged, and the
    lax fallback still runs (bm affects the Pallas path only)."""
    import dataclasses

    from mcport.engine.mc_engine import _run_digest

    fast_cfg = dataclasses.replace(CFG, bm="poly_fast")
    assert _run_digest(PARAMS, W, fast_cfg) != _run_digest(PARAMS, W, CFG)
    r_fast, _ = run_resumable_mc(PARAMS, W, fast_cfg, sketch=SKETCH)
    r_def, _ = run_resumable_mc(PARAMS, W, CFG, sketch=SKETCH)
    # lax path ignores bm: identical results
    assert r_fast.var == r_def.var and r_fast.cvar == r_def.cvar


def test_indivisible_block_raises():
    with pytest.raises(ValueError):
        run_resumable_mc(PARAMS, W, GBMConfig(n_paths=1000, path_block=512, use_pallas=False))


def test_seed_changes_results():
    r1, _ = run_resumable_mc(PARAMS, W, CFG, SKETCH)
    r2, _ = run_resumable_mc(
        PARAMS, W, GBMConfig(**{**CFG.__dict__, "seed": 6}), SKETCH
    )
    assert r1.var != r2.var


def test_recovery_driver_survives_transient_aborts(tmp_path, monkeypatch):
    """Inject transient device failures between segments; the recovery driver
    must produce results bit-identical to an uninterrupted run."""
    import jax

    import mcport.engine.mc_engine as eng

    baseline, _ = run_resumable_mc(PARAMS, W, CFG, SKETCH)

    real = eng.run_resumable_mc
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] in (2, 4):  # fail the 2nd and 4th segments
            raise jax.errors.JaxRuntimeError("ABORTED: device backend error (Aborted).")
        return real(*args, **kwargs)

    monkeypatch.setattr(eng, "run_resumable_mc", flaky)
    report = eng.run_resumable_mc_with_recovery(
        PARAMS, W, CFG, SKETCH, checkpoint_path=tmp_path / "r.npz",
        segment_blocks=2, max_restarts=2,
    )
    assert calls["n"] > 4  # failures actually happened and were retried
    assert report.var == baseline.var and report.cvar == baseline.cvar
    np.testing.assert_array_equal(report.mean, baseline.mean)
    np.testing.assert_array_equal(report.cov, baseline.cov)


def test_recovery_driver_gives_up_on_permanent_failure(tmp_path, monkeypatch):
    import jax

    import mcport.engine.mc_engine as eng

    def always_fail(*args, **kwargs):
        raise jax.errors.JaxRuntimeError("ABORTED: device backend error (Aborted).")

    monkeypatch.setattr(eng, "run_resumable_mc", always_fail)
    with pytest.raises(jax.errors.JaxRuntimeError):
        eng.run_resumable_mc_with_recovery(
            PARAMS, W, CFG, SKETCH, checkpoint_path=tmp_path / "p.npz",
            segment_blocks=2, max_restarts=2,
        )


def test_stale_checkpoint_for_other_run_rejected(tmp_path):
    """A checkpoint bound to one (params, weights, seed) must not silently
    resume a different computation (digest guard)."""
    path = tmp_path / "d.npz"
    run_resumable_mc(PARAMS, W, CFG, SKETCH, max_blocks=2, checkpoint_path=path)
    ck = load_checkpoint(path)
    other_w = np.array([0.2, 0.3, 0.5])
    with pytest.raises(ValueError, match="digest"):
        run_resumable_mc(PARAMS, other_w, CFG, SKETCH, checkpoint=ck)


def test_old_format_checkpoint_clear_error(tmp_path):
    path = tmp_path / "old.npz"
    np.savez(path, seed=0, n_steps=8, block_paths=1024, n_blocks=8, next_block=1,
             count=np.zeros(()), sum=np.zeros(3), outer=np.zeros((3, 3)),
             hist=np.zeros(64), port_sum=np.zeros(()), antithetic=False)
    with pytest.raises(ValueError, match="older mcport version"):
        load_checkpoint(path)
