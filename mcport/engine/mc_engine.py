"""Chunked, checkpointable Monte-Carlo risk engine (single-chip driver loop).

SURVEY.md §5 "Checkpoint / resume": the engine is a deterministic function of
(moments, seed, config); a block ``b`` always draws stream ``seed + (b+1) *
SEED_STRIDE`` regardless of when or where it runs, so checkpointing is just
serializing ``(next_block, moment accumulators, histogram counts)`` — needed for
the 16M-path tail-risk config (BASELINE.json:10) on preemptible machines.

The per-block update stays on device (moments/histogram fold in-place); state only
crosses to host on explicit ``save``. Path generator: the fused terminal kernel
on the GPU, the lax reference elsewhere (:func:`mcport.ops.dispatch.use_kernels`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.config import GBMConfig, SketchConfig
from mcport.models.gbm import (
    GBMParams,
    portfolio_terminal_returns,
    terminal_log_returns,
    terminal_log_returns_t,
)
from mcport.ops.dispatch import use_kernels
from mcport.ops.quantile import (
    MomentState,
    auto_sketch,
    finalize_moments,
    histogram,
    sketch_var_cvar,
    sketch_var_cvar_ci,
    update_moments,
)
from mcport.seeding import SEED_STRIDE

__all__ = ["MCCheckpoint", "RiskReport", "run_resumable_mc",
           "run_resumable_mc_with_recovery", "load_checkpoint"]


def _run_digest(params: GBMParams, weights, config: GBMConfig, hedge=None) -> str:
    """Binds a checkpoint to the exact computation: params, weights, seed, grid.
    Resuming with anything else is a different run and must be rejected, not
    silently continued (a stale checkpoint under a reused path would otherwise
    return the previous run's results)."""
    import hashlib

    h = hashlib.sha256()
    for arr in (params.mean_step, params.chol_step, np.asarray(weights, np.float64)):
        h.update(np.ascontiguousarray(arr, np.float64).tobytes())
    h.update(f"{config.seed}|{config.n_steps}|{config.n_paths}|"
             f"{config.path_block}|{config.antithetic}|"
             f"{config.innovations}|{config.t_dof}".encode())
    if getattr(config, "bm", "poly") != "poly" and config.innovations != "student_t":
        # stream-affecting normal tier; appended only when non-default so
        # pre-round-4 checkpoints keep their digests — and only when it
        # actually changes the stream (the Student-t sampler ignores bm, so
        # a student_t run draws identically with or without the flag)
        h.update(f"|bm={config.bm}".encode())
    if hedge is not None:
        h.update(b"hedge|" + hedge.digest_bytes())
    return h.hexdigest()


@dataclass
class MCCheckpoint:
    """Serializable engine state. ``next_block`` is the resume cursor.

    ``sum_c``/``outer_c`` are the Neumaier compensation terms of the moment
    accumulators; ``shift`` is the drift centering subtracted from every sample
    (stored so a resumed session finalizes with the exact value the accumulation
    used). The sketch geometry is stored so a resume reconstructs the same bins.
    """

    seed: int
    n_steps: int
    block_paths: int
    n_blocks: int
    next_block: int
    count: np.ndarray
    sum: np.ndarray
    sum_c: np.ndarray
    outer: np.ndarray
    outer_c: np.ndarray
    shift: np.ndarray
    hist: np.ndarray
    port_sum: np.ndarray
    sketch_lo: float
    sketch_hi: float
    sketch_space: str
    antithetic: bool = False
    digest: str = ""

    def save(self, path: str | Path) -> None:
        np.savez(
            path,
            **{f.name: getattr(self, f.name) for f in dataclasses.fields(self)},
        )

    @property
    def done(self) -> bool:
        return self.next_block >= self.n_blocks

    @property
    def sketch(self) -> SketchConfig:
        return SketchConfig(
            n_bins=int(np.asarray(self.hist).shape[-1]),
            lo=float(self.sketch_lo),
            hi=float(self.sketch_hi),
            space=str(self.sketch_space),
        )


def load_checkpoint(path: str | Path) -> MCCheckpoint:
    with np.load(path) as z:
        missing = {"sum_c", "outer_c", "shift", "sketch_lo"} - set(z.files)
        if missing:
            raise ValueError(
                f"checkpoint {path} was written by an older mcport version "
                f"(missing fields {sorted(missing)}); it cannot be resumed by "
                "this version — rerun from scratch or keep the old version to "
                "finish it"
            )
        return MCCheckpoint(
            seed=int(z["seed"]),
            n_steps=int(z["n_steps"]),
            block_paths=int(z["block_paths"]),
            n_blocks=int(z["n_blocks"]),
            next_block=int(z["next_block"]),
            count=z["count"],
            sum=z["sum"],
            sum_c=z["sum_c"],
            outer=z["outer"],
            outer_c=z["outer_c"],
            shift=z["shift"],
            hist=z["hist"],
            port_sum=z["port_sum"],
            sketch_lo=float(z["sketch_lo"]),
            sketch_hi=float(z["sketch_hi"]),
            sketch_space=str(z["sketch_space"]),
            antithetic=bool(z["antithetic"]),
            digest=str(z["digest"]) if "digest" in z.files else "",
        )


@dataclass(frozen=True)
class RiskReport:
    """Final risk statistics of a (possibly multi-session) MC run."""

    mean: np.ndarray    # (A,) terminal log-return mean
    cov: np.ndarray     # (A, A)
    var: float          # portfolio VaR at alpha (simple-return units)
    cvar: float
    port_mean: float
    n_paths: int
    tail_ci: dict | None = None   # config.ci_boot > 0: bootstrap error bars
                                  # {var_lo/hi/se, cvar_lo/hi/se} (floats)


@partial(
    jax.jit,
    static_argnames=(
        "n_dispatch_blocks", "block_paths", "n_steps", "use_pallas", "antithetic",
        "sketch", "innovations", "t_dof", "hedged", "bm",
    ),
)
def _blocks_update(
    seed: Array,
    first_block: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    shift: Array,
    moments: MomentState,
    hist: Array,
    port_sum: Array,
    n_dispatch_blocks: int,
    block_paths: int,
    n_steps: int,
    use_pallas: bool,
    antithetic: bool,
    sketch: SketchConfig,
    innovations: str = "normal",
    t_dof: float = 6.0,
    hedged: bool = False,
    hedge_args: tuple = (),
    bm: str = "poly",
):
    """Fold ``n_dispatch_blocks`` consecutive path blocks in ONE device dispatch.

    Block b (absolute index) always draws stream ``seed + (b+1)*SEED_STRIDE``
    and blocks accumulate left-to-right, so results are bit-identical for any
    dispatch grouping — resume equivalence does not depend on chunking. Batching
    saves host dispatches.
    """

    def one_block(b, carry):
        moments, hist, port_sum = carry
        block_seed = (seed + (first_block + b + 1) * SEED_STRIDE).astype(jnp.int32)
        if use_pallas:
            from mcport.ops.pallas_gbm import pallas_terminal_log_returns

            term = pallas_terminal_log_returns(
                block_seed, mean_step, chol_step, block_paths, n_steps,
                antithetic=antithetic,
                t_df=t_dof if innovations == "student_t" else None,
                bm=bm,
            )
        elif innovations == "student_t":
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            term = terminal_log_returns_t(
                key, mean_step, chol_step, t_dof, block_paths, n_steps,
                antithetic=antithetic,
            )
        else:
            key = jax.random.fold_in(jax.random.PRNGKey(0), block_seed)
            term = terminal_log_returns(
                key, mean_step, chol_step, block_paths, n_steps, antithetic=antithetic
            )
        if hedged:
            # option legs settle at intrinsic value against the simulated
            # terminal prices (elementwise PWL, fuses with the weight dot);
            # asset moments stay the plain log-return moments — only the
            # PORTFOLIO tail statistics change
            from mcport.options.hedged import hedged_terminal_returns

            port = hedged_terminal_returns(term, *hedge_args) @ weights
        else:
            port = portfolio_terminal_returns(term, weights)
        return (
            update_moments(moments, term, shift=shift),
            hist + histogram(port, sketch),
            port_sum + port.sum(),
        )

    return jax.lax.fori_loop(
        0, n_dispatch_blocks, one_block, (moments, hist, port_sum)
    )


def run_resumable_mc(
    params: GBMParams,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    alpha: float = 0.95,
    checkpoint: MCCheckpoint | None = None,
    max_blocks: int | None = None,
    checkpoint_path: str | Path | None = None,
    dispatch_blocks: int = 16,
    hedge=None,
) -> tuple[RiskReport, MCCheckpoint]:
    """Run (or resume) a chunked MC risk computation.

    ``hedge`` (a :class:`mcport.options.hedged.HedgeSpec`) makes the
    portfolio tail statistics HEDGED: option legs settle at intrinsic value
    against the simulated terminal prices (terminal composition,
    app.py:164-180 over the horizon). Asset moments (mean/cov) remain the
    plain log-return moments. The hedge is part of the run digest, and the
    default sketch switches to the exact PWL-bounds linear form
    (:func:`mcport.options.hedged.auto_hedged_sketch`).

    ``sketch=None`` (default) derives an adaptive log1p-space sketch from the GBM
    parameters via :func:`mcport.ops.quantile.auto_sketch` — guaranteed to cover
    the return range, no silent clamping. A resumed run reuses the checkpoint's
    stored sketch geometry (and rejects a conflicting explicit one).

    ``max_blocks`` bounds this call's work (preemption simulation / incremental
    runs); pass the returned checkpoint (or its saved file) to continue. Identical
    final state regardless of how the blocks were split across calls.
    ``dispatch_blocks`` groups that many blocks into one device dispatch;
    grouping never changes results — accumulation order is block-sequential
    either way.
    """
    a = params.n_assets
    block_paths = config.path_block
    if config.n_paths % block_paths:
        raise ValueError(f"n_paths {config.n_paths} not divisible by path_block {block_paths}")
    n_blocks = config.n_paths // block_paths

    digest = _run_digest(params, weights, config, hedge)
    if checkpoint is None:
        if sketch is None:
            t_dof = config.t_dof if config.innovations == "student_t" else None
            if hedge is not None:
                from mcport.options.hedged import auto_hedged_sketch

                w_np = np.asarray(weights, np.float64)
                sketch = auto_hedged_sketch(
                    params, config.n_steps, hedge,
                    weights=w_np if (w_np >= 0).all() else None, t_dof=t_dof,
                )
            else:
                sketch = auto_sketch(
                    params.mean_step, params.chol_step, config.n_steps,
                    t_dof=t_dof,
                )
        shift_np = np.asarray(config.n_steps * np.asarray(params.mean_step, np.float64))
        ck = MCCheckpoint(
            seed=config.seed,
            n_steps=config.n_steps,
            block_paths=block_paths,
            n_blocks=n_blocks,
            next_block=0,
            count=np.zeros(()),
            sum=np.zeros(a),
            sum_c=np.zeros(a),
            outer=np.zeros((a, a)),
            outer_c=np.zeros((a, a)),
            shift=shift_np,
            hist=np.zeros(sketch.n_bins),
            port_sum=np.zeros(()),
            sketch_lo=sketch.lo,
            sketch_hi=sketch.hi,
            sketch_space=sketch.space,
            antithetic=config.antithetic,
            digest=digest,
        )
    else:
        ck = checkpoint
        if (ck.n_steps, ck.block_paths, ck.n_blocks) != (config.n_steps, block_paths, n_blocks):
            raise ValueError("checkpoint is for a different run configuration")
        if ck.digest and ck.digest != digest:
            raise ValueError(
                "checkpoint was written for different parameters/weights/seed "
                "(digest mismatch) — refusing to resume a different computation"
            )
        if sketch is None:
            sketch = ck.sketch
        elif sketch != ck.sketch:
            raise ValueError("sketch config conflicts with the checkpoint's stored sketch")

    dtype = jnp.dtype(config.dtype)
    mean_step = jnp.asarray(params.mean_step, dtype)
    chol_step = jnp.asarray(params.chol_step, dtype)
    w = jnp.asarray(weights, dtype)
    shift = jnp.asarray(ck.shift, dtype)
    moments = MomentState(
        jnp.asarray(ck.count, dtype),
        jnp.asarray(ck.sum, dtype),
        jnp.asarray(ck.sum_c, dtype),
        jnp.asarray(ck.outer, dtype),
        jnp.asarray(ck.outer_c, dtype),
    )
    hist = jnp.asarray(ck.hist, dtype)
    port_sum = jnp.asarray(ck.port_sum, dtype)

    use_pallas = use_kernels(config.use_pallas)
    hedge_args = () if hedge is None else (
        jnp.asarray(params.s0, dtype), *hedge.arrays)

    start = ck.next_block
    stop = n_blocks if max_blocks is None else min(n_blocks, start + max_blocks)
    b = start
    while b < stop:
        group = min(dispatch_blocks, stop - b)
        moments, hist, port_sum = _blocks_update(
            jnp.asarray(ck.seed, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
            jnp.asarray(b, jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
            mean_step, chol_step, w, shift, moments, hist, port_sum,
            group, block_paths, config.n_steps, use_pallas, config.antithetic,
            sketch, config.innovations, config.t_dof,
            hedge is not None, hedge_args, getattr(config, "bm", "poly"),
        )
        b += group

    jax.block_until_ready(hist)
    ck = MCCheckpoint(
        seed=ck.seed,
        n_steps=ck.n_steps,
        block_paths=block_paths,
        n_blocks=n_blocks,
        next_block=stop,
        count=np.asarray(moments.count),
        sum=np.asarray(moments.sum),
        sum_c=np.asarray(moments.sum_c),
        outer=np.asarray(moments.outer),
        outer_c=np.asarray(moments.outer_c),
        shift=np.asarray(ck.shift),
        hist=np.asarray(hist),
        port_sum=np.asarray(port_sum),
        sketch_lo=sketch.lo,
        sketch_hi=sketch.hi,
        sketch_space=sketch.space,
        antithetic=ck.antithetic,
        digest=digest,
    )
    if checkpoint_path is not None:
        ck.save(checkpoint_path)

    n_done = int(ck.count) if int(ck.count) else 1
    mean, cov = finalize_moments(moments, shift=shift)
    v, c = sketch_var_cvar(hist, alpha, sketch)
    tail_ci = None
    if getattr(config, "ci_boot", 0) > 0:
        from mcport.ops.quantile import tail_ci_fields

        tail_ci = tail_ci_fields(sketch_var_cvar_ci(
            hist, alpha, sketch, n_boot=int(config.ci_boot),
            seed=config.seed))
    report = RiskReport(
        mean=np.asarray(mean),
        cov=np.asarray(cov),
        var=float(v),
        cvar=float(c),
        port_mean=float(port_sum) / n_done,
        n_paths=int(ck.count),
        tail_ci=tail_ci,
    )
    return report, ck


def run_resumable_mc_with_recovery(
    params: GBMParams,
    weights: np.ndarray,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    alpha: float = 0.95,
    checkpoint_path: str | Path = "mc_checkpoint.npz",
    segment_blocks: int = 64,
    max_restarts: int = 3,
    dispatch_blocks: int = 16,
    hedge=None,
) -> RiskReport:
    """Elastic driver: run in checkpointed segments, surviving transient device
    failures (SURVEY.md §5 "failure detection / elastic recovery").

    A device can abort mid-run (``JaxRuntimeError``); because every block is
    counter-addressed, recovery is simply "reload the last checkpoint and
    continue" — results are bit-identical to an uninterrupted run regardless of
    where the failures land. ``max_restarts`` bounds consecutive failed
    segments (progress resets the budget); a permanently-failing device
    re-raises the last error.
    """
    import jax

    checkpoint_path = Path(checkpoint_path)
    ck = load_checkpoint(checkpoint_path) if checkpoint_path.exists() else None
    failures = 0
    while True:
        try:
            report, ck = run_resumable_mc(
                params, weights, config, sketch, alpha=alpha,
                checkpoint=ck, max_blocks=segment_blocks,
                checkpoint_path=checkpoint_path,
                dispatch_blocks=dispatch_blocks, hedge=hedge,
            )
            failures = 0
        except jax.errors.JaxRuntimeError:
            failures += 1
            if failures > max_restarts:
                raise
            # the device state is gone; resume from the last durable checkpoint
            ck = (load_checkpoint(checkpoint_path)
                  if checkpoint_path.exists() else None)
            continue
        if ck.done:
            return report
