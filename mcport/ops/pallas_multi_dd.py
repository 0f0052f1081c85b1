"""Fused multi-portfolio drawdown kernel (Pallas, Triton route): W candidate
portfolios evolve through one set of GBM paths, scored at every step.

``gbm_path_stats`` tracks one portfolio; this kernel scores a tile of
candidates per step: the asset state exponentiates once ((A_pad, block)) and
the candidate values come from ``W_tile @ exp(logS)``, a (tile, A_pad) x
(A_pad, block) ``pl.dot`` with K = A_pad (16 for up to 16 assets). Running
peaks and maximum drawdowns live in registers per (candidate, path).

The grid is 2-D: path blocks x candidate tiles. A (256, block) carry does not
fit in a block's registers, so each program holds one tile of candidates and
re-derives its path block's draws (same key ``(seed, block)``), which makes
every tile score the identical paths.

Outputs: terminal candidate returns and max drawdowns, both (W, n_paths).
Downstream code reduces them to per-candidate tail statistics
(:mod:`mcport.engine.drawdown_frontier`, :mod:`mcport.engine.path_risk`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl

from mcport.ops.dispatch import kernel_interpret
from mcport.ops.pallas_gbm import (
    F32,
    _padded_factor,
    _round_up,
    compiler_params,
    correlate,
    paired_step_loop,
    shock_pair,
)

__all__ = ["gbm_multi_portfolio_dd", "BF16_DD_ERR_BOUND",
           "BF16_DD_ERR_REBAL_COEF"]

# Candidate rows per program and warps, chosen on an H100 for 256 candidates
# x 131,072 paths with 64-path blocks (PERF.md, "Register budget").
_TILE = 64
_WARPS = 4

# Pinned bf16-screening drawdown perturbation bounds. These are the SINGLE
# source of truth shared by the rescore margin in
# mcport.engine.drawdown_frontier and the error assertions in
# tests/test_drawdown_frontier.py, so the margin and the tested bounds cannot
# drift apart: a candidate whose true f32 dd_p95 is within budget but whose
# bf16 screen errs pessimistically by up to the bound must land inside the
# rescore pool for the exact-optimum guarantee.
BF16_DD_ERR_BOUND = 8e-3        # buy-and-hold |dd_p95| bound (tested at 13-26 steps)
BF16_DD_ERR_REBAL_COEF = 1.4e-2  # rebalance widening: coef*sqrt(n_steps) (~5e-2 @ 13)


def _hedged_returns(hedge, p_prev, p_new):
    """Per-period option settlement (mcport.options.hedged semantics,
    app.py:164-180 per simulated step): the qty-weighted hedged return of
    each asset for the move ``p_prev -> p_new``. ``hedge = (type, strike,
    premium, qty)``, each indexable by leg into an (A_pad, 1) column; leg
    types are a 7-way select, qty-0 padding legs contribute exactly zero."""
    ht, hk, hp, hq = hedge
    up = p_new - p_prev
    r = jnp.zeros_like(p_new)
    for leg in range(ht.shape[0]):
        t, k, prem, q = ht[leg], hk[leg], hp[leg], hq[leg]
        call_iv = jnp.maximum(p_new - k, 0.0)
        put_iv = jnp.maximum(k - p_new, 0.0)
        numer = jnp.where(
            t == 0, up, jnp.where(
                (t == 1) | (t == 6), -up, jnp.where(
                    t == 2, call_iv - prem, jnp.where(
                        t == 3, prem - call_iv, jnp.where(
                            t == 4, put_iv - prem, jnp.where(
                                t == 5, prem - put_iv,
                                0.0))))))  # unknown type: 0, matching
        # legs.leg_period_return's default branch (HedgeSpec.build validates
        # types, so this is defense in depth, not dispatch)
        r = r + q * numer
    return r / p_prev


def _score_dot(w: Array, score_dtype: str):
    """``e -> W @ e`` at the candidate-scoring tier: "float32" (IEEE, exact),
    "tensorfloat32" (TF32 tensor cores, ~1e-3 relative operand rounding)
    or "bfloat16" (bf16 operands, f32 accumulation; screening only)."""
    if score_dtype == "bfloat16":
        w_b = w.astype(jnp.bfloat16)
        return lambda e: jnp.dot(w_b, e.astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32)
    precision = lax.Precision.HIGH if score_dtype == "tensorfloat32" else F32
    return lambda e: jnp.dot(w, e, precision=precision,
                             preferred_element_type=jnp.float32)


def _multi_dd_block(seed, b, m, lt, w, s0, hedge, *, n_steps, a_shape,
                    score_dtype, rebalance, t_df, bm):
    """(terminal returns, max drawdowns), both (tile, block), of candidate
    rows ``w`` over path block ``b`` — the kernel body and the twin's
    per-block function."""
    pair = shock_pair(seed, b, a_shape, bm, t_df)
    score = _score_dot(w, score_dtype)
    c_shape = (w.shape[0], a_shape[1])
    ones = jnp.ones(c_shape, jnp.float32)
    zeros = jnp.zeros(c_shape, jnp.float32)

    if hedge is not None:
        # hedged per-period settlement: the asset PRICE state evolves; each
        # step settles every leg at intrinsic value against P -> P exp(x) and
        # candidates compound V_{t+1} = V_t (1 + W r_hedged)
        def one_step(z, carry):
            p, v, peak, dd = carry
            p_new = p * jnp.exp(m + correlate(lt, z))
            v = v * (1.0 + score(_hedged_returns(hedge, p, p_new)))
            peak = jnp.maximum(peak, v)
            return p_new, v, peak, jnp.minimum(dd, v / peak - 1.0)

        p0 = jnp.broadcast_to(s0, a_shape).astype(jnp.float32)
        _, v, _, dd = paired_step_loop(pair, one_step, (p0, ones, ones, zeros),
                                       n_steps)
        return v - 1.0, dd

    if rebalance:
        # per-period rebalancing to the candidate weights (the reference's
        # historical R·w convention, app.py:710): V_{t+1} = V_t (W exp(x_t))
        def one_step(z, carry):
            v, peak, dd = carry
            v = v * score(jnp.exp(m + correlate(lt, z)))
            peak = jnp.maximum(peak, v)
            return v, peak, jnp.minimum(dd, v / peak - 1.0)

        v, _, dd = paired_step_loop(pair, one_step, (ones, ones, zeros),
                                    n_steps)
        return v - 1.0, dd

    def one_step(z, carry):
        acc, peak, dd = carry
        acc = acc + m + correlate(lt, z)
        v = score(jnp.exp(acc))
        peak = jnp.maximum(peak, v)
        return acc, peak, jnp.minimum(dd, v / peak - 1.0)

    # V_0 = sum w = 1; padded candidate rows are all-zero and sliced away
    acc, _, dd = paired_step_loop(
        pair, one_step, (jnp.zeros(a_shape, jnp.float32), ones, zeros), n_steps)
    # buy-and-hold terminal returns stay exact f32 at every scoring tier
    return jnp.dot(w, jnp.exp(acc), precision=F32,
                   preferred_element_type=jnp.float32) - 1.0, dd


def _multi_dd_kernel(seed_ref, m_ref, lt_ref, w_ref, *rest, a_pad, hedged,
                     **kw):
    if hedged:
        s0_ref, ht_ref, hk_ref, hp_ref, hq_ref, term_ref, dd_ref = rest
        s0, hedge = s0_ref[...], (ht_ref, hk_ref, hp_ref, hq_ref)
    else:
        term_ref, dd_ref = rest
        s0 = hedge = None
    term, dd = _multi_dd_block(
        seed_ref[0], pl.program_id(0), m_ref[...], lt_ref[...], w_ref[...],
        s0, hedge, a_shape=(a_pad, term_ref.shape[1]), **kw)
    term_ref[...] = term
    dd_ref[...] = dd


@functools.partial(
    jax.jit,
    static_argnames=("n_paths", "n_steps", "block", "interpret", "score_dtype",
                     "rebalance", "t_df", "bm", "reference"))
def gbm_multi_portfolio_dd(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    block: int = 64,
    interpret: bool = False,
    score_dtype: str = "float32",
    rebalance: bool = False,
    hedge_args: tuple | None = None,
    t_df: float | None = None,
    bm: str = "poly",
    reference: bool = False,
) -> tuple[Array, Array]:
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) for W
    candidates (``weights`` is (W, A); any W, tiled ``_TILE`` rows per
    program).

    ``score_dtype`` picks the per-step candidate-value product: "float32"
    (default, exact), "tensorfloat32" or "bfloat16" (screening; re-evaluate
    winners at f32 if the dd VALUE matters, see engine/drawdown_frontier.py).
    Buy-and-hold terminal returns stay exact f32 in every mode.

    ``rebalance=True`` rebalances every candidate to its target weights each
    period (V_{t+1} = V_t · w'exp(x_t), the reference's historical-series
    semantics, app.py:710) instead of buy-and-hold.

    ``hedge_args = (s0 (A,), type_id (A, L) int, strike (A, L), premium (A,
    L), qty (A, L))`` switches to HEDGED per-period settlement
    (mcport.options.hedged semantics, app.py:164-193 per simulated step):
    candidates compound ``V_{t+1} = V_t · (1 + W r_hedged_t)`` (``rebalance``
    is implied).

    ``t_df`` swaps the shocks for unit-variance Student-t draws;
    ``bm="poly_fast"`` the screening-tier normals (a different stream).
    ``reference=True`` runs the plain-jnp twin on the same draws.
    """
    lt, a_pad = _padded_factor(chol_step, t_df)
    m = jnp.asarray(mean_step, jnp.float32)
    w = jnp.asarray(weights, jnp.float32)
    w_cnt, a = w.shape
    w_pad = _round_up(w_cnt, _TILE)
    m_p = jnp.zeros((a_pad, 1), jnp.float32).at[:a, 0].set(m)
    w_p = jnp.zeros((w_pad, a_pad), jnp.float32).at[:w_cnt, :a].set(w)
    n_pad = _round_up(n_paths, block)
    n_blocks = n_pad // block
    seed = jnp.asarray(seed).astype(jnp.int32)

    hedged = hedge_args is not None
    hedge_inputs = []
    if hedged:
        s0, ht, hk, hp, hq = hedge_args
        n_legs = ht.shape[-1]
        l_pad = 1 << (n_legs - 1).bit_length()
        # s0 padding 1.0 keeps r / p_prev defined on padded rows; padded rows
        # and legs have qty 0, so they contribute nothing
        s0_p = jnp.ones((a_pad, 1), jnp.float32).at[:a, 0].set(
            jnp.asarray(s0, jnp.float32))

        def legs(x, dt):   # (A, L) -> (L_pad, A_pad, 1), one column per leg
            return jnp.zeros((l_pad, a_pad, 1), dt).at[:n_legs, :a, 0].set(
                jnp.asarray(x, dt).T)

        hedge_inputs = [s0_p, legs(ht, jnp.int32), legs(hk, jnp.float32),
                        legs(hp, jnp.float32), legs(hq, jnp.float32)]

    kw = dict(n_steps=n_steps, score_dtype=score_dtype, rebalance=rebalance,
              t_df=t_df, bm=bm)
    if reference:
        s0_r, hedge_r = ((hedge_inputs[0], tuple(hedge_inputs[1:]))
                         if hedged else (None, None))
        term, dd = jax.vmap(lambda b: _multi_dd_block(
            seed, b, m_p, lt, w_p, s0_r, hedge_r, a_shape=(a_pad, block),
            **kw))(jnp.arange(n_blocks, dtype=jnp.int32))
        term = term.transpose(1, 0, 2).reshape(w_pad, n_pad)
        dd = dd.transpose(1, 0, 2).reshape(w_pad, n_pad)
        return term[:w_cnt, :n_paths], dd[:w_cnt, :n_paths]

    whole = lambda shape: pl.BlockSpec(shape, lambda i, j: (0,) * len(shape))
    hedge_specs = []
    if hedged:
        leg_shape = hedge_inputs[1].shape
        hedge_specs = [whole((a_pad, 1))] + [whole(leg_shape)] * 4
    out_spec = pl.BlockSpec((_TILE, block), lambda i, j: (j, i))
    term, dd = pl.pallas_call(
        functools.partial(_multi_dd_kernel, a_pad=a_pad, hedged=hedged, **kw),
        grid=(n_blocks, w_pad // _TILE),
        in_specs=[
            whole((1,)),
            whole((a_pad, 1)),
            whole((a_pad, a_pad)),
            pl.BlockSpec((_TILE, a_pad), lambda i, j: (j, 0)),
            *hedge_specs,
        ],
        out_specs=(out_spec, out_spec),
        out_shape=(
            jax.ShapeDtypeStruct((w_pad, n_pad), jnp.float32),
            jax.ShapeDtypeStruct((w_pad, n_pad), jnp.float32),
        ),
        backend="triton",
        compiler_params=compiler_params(_WARPS),
        interpret=kernel_interpret(interpret),
        name="gbm_multi_portfolio_dd",
    )(seed.reshape(1), m_p, lt, w_p, *hedge_inputs)
    return term[:w_cnt, :n_paths], dd[:w_cnt, :n_paths]
