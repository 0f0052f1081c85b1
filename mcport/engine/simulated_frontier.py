"""Simulated-path frontier search: batched argmax over candidate portfolios
scored against Monte-Carlo GBM terminals.

The reference scores candidates only against *historical* returns
(app.py:708-717). This module adds the forward-looking variant the north star
describes (BASELINE.json:5): draw one set of correlated GBM terminal returns,
then score millions of Dirichlet candidates against it — the score matrix is a
``(paths, A) x (A, B)`` matmul per candidate block, and tail metrics come
from ``lax.top_k`` over the path axis (exact k-worst means, no full sort).

Tail-metric convention (differs deliberately from the historical estimator's
np.percentile interpolation): with ``k = ceil((1-alpha) * n_paths)``, VaR is the
k-th worst simulated return and CVaR the mean of the k worst. For n_paths in the
tens of thousands the difference from interpolated quantiles is far below MC
noise, and the top-k form is exact for "mean of the worst k".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.models.gbm import GBMParams, terminal_log_returns
from mcport.ops.dirichlet import (
    _dirichlet1,
    _sample_unconstrained,
    sample_constrained_weights,
)

__all__ = [
    "SimFrontierResult",
    "simulated_weight_search",
    "StreamingFrontierResult",
    "simulated_weight_search_streaming",
]

OBJECTIVES = ("sharpe", "var", "cvar", "return")


class _Scores(NamedTuple):
    ret: Array
    std: Array
    sharpe: Array
    var: Array
    cvar: Array


@dataclass(frozen=True)
class SimFrontierResult:
    weights: np.ndarray     # (N, A) candidates
    valid: np.ndarray       # (N,)
    ret: np.ndarray         # (N,) mean simulated portfolio return
    std: np.ndarray         # (N,)
    sharpe: np.ndarray      # (N,)
    var: np.ndarray         # (N,) k-th worst simulated return
    cvar: np.ndarray        # (N,) mean of the k worst
    opt_idx: int
    objective: str

    @property
    def opt_weights(self) -> np.ndarray:
        return self.weights[self.opt_idx]


@partial(
    jax.jit,
    static_argnames=("n_candidates", "n_paths", "n_steps", "alpha", "cand_block", "dtype",
                     "trivial_bounds", "hedged"),
)
def _score_candidates(
    key: Array,
    mean_step: Array,
    chol_step: Array,
    min_w: Array,
    max_w: Array,
    risk_free: float,
    n_candidates: int,
    n_paths: int,
    n_steps: int,
    alpha: float,
    cand_block: int,
    dtype=jnp.float32,
    trivial_bounds: bool = False,
    hedged: bool = False,
    hedge_args: tuple = (),
):
    k_path, k_w = jax.random.split(key)
    term = terminal_log_returns(
        k_path, mean_step.astype(dtype), chol_step.astype(dtype), n_paths, n_steps,
        dtype=dtype,
    )
    if hedged:
        # option legs settle at intrinsic value against the simulated terminal
        # price — elementwise PWL transform, fused into the score matmul chain
        from mcport.options.hedged import hedged_terminal_returns

        gross = hedged_terminal_returns(term, *hedge_args)   # (P, A) hedged returns
    else:
        gross = jnp.exp(term) - 1.0                          # (P, A) simple returns
    if trivial_bounds:
        _, sub = jax.random.split(k_w)
        w, valid = _sample_unconstrained(sub, n_candidates, min_w.shape[-1])
    else:
        w, valid = sample_constrained_weights(k_w, n_candidates, min_w, max_w)
    w = w.astype(dtype)

    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))
    block = min(cand_block, n_candidates)
    n_pad = -(-n_candidates // block) * block
    w_pad = jnp.pad(w, ((0, n_pad - n_candidates), (0, 0)))

    def chunk(w_blk: Array) -> _Scores:
        port = gross @ w_blk.T                               # (P, B) matmul
        ret = port.mean(axis=0)
        std = port.std(axis=0, ddof=1)
        sharpe = jnp.where(std > 0, (ret - risk_free) / jnp.where(std > 0, std, 1.0), 0.0)
        worst, _ = jax.lax.top_k(-port.T, k_tail)            # (B, k) largest losses
        var = -worst[:, -1]                                  # k-th worst return
        cvar = -worst.mean(axis=1)
        return _Scores(ret, std, sharpe, var, cvar)

    s = jax.lax.map(chunk, w_pad.reshape(-1, block, w.shape[-1]))
    s = _Scores(*(x.reshape(-1)[:n_candidates] for x in s))
    return w, valid, s


def simulated_weight_search(
    key: Array,
    params: GBMParams,
    n_candidates: int = 100_000,
    n_paths: int = 16_384,
    n_steps: int = 252,
    objective: str = "cvar",
    alpha: float = 0.95,
    risk_free: float = 0.0,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    cand_block: int = 2_048,
    dtype=jnp.float32,
    hedge=None,
) -> SimFrontierResult:
    """Find the candidate portfolio optimizing a *simulated* risk objective.

    objective: "sharpe" | "return" (maximize), "var" | "cvar" (maximize the tail
    metric = minimize tail loss, matching the reference's net semantics).

    ``hedge`` (a :class:`mcport.options.hedged.HedgeSpec`) scores candidates
    against HEDGED terminal returns: each asset's option legs settle at
    intrinsic value against its simulated terminal price (app.py:164-180
    applied to the horizon). The optimum is then the best hedged portfolio —
    the composition the reference cannot do (it hedges only historical
    series, app.py:657-667).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; expected one of {OBJECTIVES}")
    a = params.n_assets
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)

    trivial = bool((np.asarray(min_w) <= 0).all() and (np.asarray(max_w) >= 1).all())
    hedge_args = ()
    if hedge is not None:
        hedge_args = (jnp.asarray(params.s0, dtype), *hedge.arrays)
    w, valid, s = _score_candidates(
        key, jnp.asarray(params.mean_step), jnp.asarray(params.chol_step),
        min_w, max_w, risk_free,
        n_candidates, n_paths, n_steps, alpha, cand_block, dtype, trivial,
        hedge is not None, hedge_args,
    )
    metric = {"sharpe": s.sharpe, "return": s.ret, "var": s.var, "cvar": s.cvar}[objective]
    neg_inf = jnp.asarray(-jnp.inf, metric.dtype)
    opt_idx = int(jnp.argmax(jnp.where(valid, metric, neg_inf)))
    return SimFrontierResult(
        weights=np.asarray(w), valid=np.asarray(valid),
        ret=np.asarray(s.ret), std=np.asarray(s.std), sharpe=np.asarray(s.sharpe),
        var=np.asarray(s.var), cvar=np.asarray(s.cvar),
        opt_idx=opt_idx, objective=objective,
    )


# ---- streaming search: constant compile cost at any candidate count ------------
#
# The cloud-returning search above materializes (N,) score vectors and, at 1M+
# constrained candidates, pays an XLA compile proportional to nothing but still
# large (lax.map body + the full-batch rejection while_loop; the >9-min compile of
# VERDICT r1 item 3). The streaming form fixes the cost structure instead of
# dodging it: ONE jitted program scores a fixed-shape chunk inside a fori_loop and
# carries only the running optimum, so compile cost is constant in N, memory is
# O(chunk), and the host loop dispatches `dispatch_chunks` chunks per device
# round-trip (as engine.mc_engine groups its blocks).
#
# Chunk c always draws stream fold_in(key, c) — results depend only on
# (key, cand_block), never on dispatch grouping.


class _BestCarry(NamedTuple):
    metric: Array    # () running best (raw form: maximize)
    ret: Array       # () mean simulated return of the best candidate
    std: Array       # ()
    weights: Array   # (A,)
    n_valid: Array   # () int32


@dataclass(frozen=True)
class StreamingFrontierResult:
    """Optimum of a streaming simulated-frontier search (no candidate cloud)."""

    opt_weights: np.ndarray
    opt_metric: float
    opt_ret: float
    opt_std: float
    n_valid: int
    n_candidates: int
    objective: str


@partial(
    jax.jit,
    static_argnames=("n_chunks", "chunk", "k_tail", "objective", "trivial_bounds"),
    donate_argnums=(5,),
)
def _fold_chunks(
    key: Array,
    first_chunk: Array,
    gross: Array,            # (P, A) simulated simple returns, device-resident
    min_w: Array,
    max_w: Array,
    carry: _BestCarry,
    risk_free: float,
    n_chunks: int,
    chunk: int,
    k_tail: int,
    objective: str,
    trivial_bounds: bool,
) -> _BestCarry:
    a = gross.shape[-1]

    def body(j, carry):
        c = first_chunk + j
        k = jax.random.fold_in(key, c)
        if trivial_bounds:
            w = _dirichlet1(k, chunk, a)
            valid = jnp.ones((chunk,), bool)
        else:
            w, valid = sample_constrained_weights(k, chunk, min_w, max_w)
        w = w.astype(gross.dtype)
        port = gross @ w.T                                   # (P, B) matmul
        ret = port.mean(axis=0)
        std = port.std(axis=0, ddof=1)
        sharpe = jnp.where(std > 0, (ret - risk_free) / jnp.where(std > 0, std, 1.0), 0.0)
        worst, _ = jax.lax.top_k(-port.T, k_tail)
        var = -worst[:, -1]
        cvar = -worst.mean(axis=1)
        metric = {"sharpe": sharpe, "return": ret, "var": var, "cvar": cvar}[objective]
        metric = jnp.where(valid, metric, -jnp.inf)
        i = jnp.argmax(metric)
        better = metric[i] > carry.metric
        sel = lambda new, old: jnp.where(better, new, old)
        return _BestCarry(
            sel(metric[i], carry.metric),
            sel(ret[i], carry.ret),
            sel(std[i], carry.std),
            sel(w[i], carry.weights),
            carry.n_valid + valid.sum().astype(jnp.int32),
        )

    return jax.lax.fori_loop(0, n_chunks, body, carry)


def simulated_weight_search_streaming(
    key: Array,
    params: GBMParams,
    n_candidates: int = 1_048_576,
    n_paths: int = 16_384,
    n_steps: int = 252,
    objective: str = "cvar",
    alpha: float = 0.95,
    risk_free: float = 0.0,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    cand_block: int = 8_192,
    dispatch_chunks: int = 16,
    dtype=jnp.float32,
    hedge=None,
) -> StreamingFrontierResult:
    """Million-candidate simulated-frontier search with constant compile cost.

    Tails are exact ``lax.top_k`` means: on an H100 (400 W power limit) the
    1M-constrained-candidate x 16,384-path search took 0.93 s warm with them
    against 1.43 s with ``lax.approx_max_k``, which the GPU lowers as a sort
    (PERF.md).

    Same scoring semantics as :func:`simulated_weight_search` (one shared GBM
    terminal set; top-k tail metrics), but candidates stream through a fixed-shape
    chunk program and only the running optimum is carried — intended for the
    BASELINE.json config-3 scale (1M constrained candidates) where the
    cloud-returning form's compile dominates. The candidate stream differs from
    the cloud-returning form's (per-chunk fold_in vs one batch draw).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; expected one of {OBJECTIVES}")
    if n_candidates % cand_block:
        raise ValueError(f"n_candidates {n_candidates} not divisible by cand_block {cand_block}")
    a = params.n_assets
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)
    trivial = bool((np.asarray(min_w) <= 0).all() and (np.asarray(max_w) >= 1).all())

    k_path, k_w = jax.random.split(key)
    term = terminal_log_returns(
        k_path, jnp.asarray(params.mean_step, dtype), jnp.asarray(params.chol_step, dtype),
        n_paths, n_steps, dtype=dtype,
    )
    if hedge is not None:
        # hedged scoring (see simulated_weight_search): the (P, A) matrix is
        # transformed ONCE here, device-resident; per-chunk cost is unchanged
        from mcport.options.hedged import hedged_terminal_returns

        gross = hedged_terminal_returns(
            term, jnp.asarray(params.s0, dtype), *hedge.arrays)
    else:
        gross = jnp.exp(term) - 1.0
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))

    carry = _BestCarry(
        jnp.asarray(-jnp.inf, dtype), jnp.asarray(jnp.nan, dtype),
        jnp.asarray(jnp.nan, dtype), jnp.full((a,), jnp.nan, dtype),
        jnp.zeros((), jnp.int32),
    )
    n_chunks = n_candidates // cand_block
    c = 0
    while c < n_chunks:
        g = min(dispatch_chunks, n_chunks - c)
        carry = _fold_chunks(
            k_w, jnp.asarray(c, jnp.int32), gross,
            jnp.asarray(min_w, dtype), jnp.asarray(max_w, dtype), carry,
            risk_free, g, cand_block, k_tail, objective, trivial,
        )
        c += g
    carry = jax.block_until_ready(carry)

    return StreamingFrontierResult(
        opt_weights=np.asarray(carry.weights),
        opt_metric=float(carry.metric),
        opt_ret=float(carry.ret),
        opt_std=float(carry.std),
        n_valid=int(carry.n_valid),
        n_candidates=n_candidates,
        objective=objective,
    )
