"""Drawdown-constrained frontier search over simulated paths.

New capability beyond the reference: select the candidate portfolio maximizing
expected simulated return subject to a max-drawdown budget — "highest return
among portfolios whose 95th-percentile worst drawdown stays above -X%". Candidate
scoring runs through :func:`mcport.ops.pallas_multi_dd.gbm_multi_portfolio_dd`
(a tile of candidates scored inside the path evolution) on the GPU, or a lax
einsum reference elsewhere; per-candidate tail statistics come from
``lax.top_k``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.models.gbm import GBMParams, simulate_log_paths
from mcport.ops.dirichlet import _sample_unconstrained, sample_constrained_weights
from mcport.ops.dispatch import use_kernels

__all__ = ["DrawdownFrontierResult", "drawdown_frontier_search",
           "family_drawdown_frontier_search"]


@dataclass(frozen=True)
class DrawdownFrontierResult:
    weights: np.ndarray     # (N, A)
    valid: np.ndarray       # (N,)
    ret: np.ndarray         # (N,) mean simulated terminal return
    dd_p95: np.ndarray      # (N,) 95th-percentile worst max drawdown
    feasible: np.ndarray    # (N,) valid & dd_p95 >= -dd_budget
    opt_idx: int            # argmax ret among feasible; -1 if none
    dd_budget: float

    @property
    def opt_weights(self) -> np.ndarray | None:
        return None if self.opt_idx < 0 else self.weights[self.opt_idx]


def _lax_multi_dd(key, mean_step, chol_step, w, n_paths, n_steps, dtype,
                  rebalance: bool = False, t_df: float | None = None):
    """Reference: full paths → per-(path, candidate) value paths → dd + terminal.

    ``rebalance=True`` compounds the per-step candidate gross factor
    (V_{t+1} = V_t · w'exp(x_t)) instead of holding the initial allocation.
    ``t_df`` draws unit-variance Student-t shocks."""
    paths = simulate_log_paths(key, mean_step, chol_step, n_paths, n_steps, dtype=dtype,
                               t_df=t_df)
    if rebalance:
        x = jnp.diff(paths, axis=1, prepend=jnp.zeros_like(paths[:, :1]))
        f = jnp.einsum("pta,wa->wpt", jnp.exp(x), w)          # per-step factors
        v = jnp.cumprod(f, axis=2)
    else:
        v = jnp.einsum("pta,wa->wpt", jnp.exp(paths), w)      # (W, P, T)
    ones = jnp.ones(v.shape[:2] + (1,), dtype)
    v = jnp.concatenate([ones, v], axis=2)
    peak = jax.lax.cummax(v, axis=2)
    dd = jnp.min(v / peak - 1.0, axis=2)                      # (W, P)
    term = v[:, :, -1] - 1.0
    return term, dd


def _lax_multi_dd_hedged(key, mean_step, chol_step, w, n_paths, n_steps, dtype,
                         s0, h_t, h_k, h_p, h_q, t_df: float | None = None):
    """Hedged candidate scoring: each simulated step settles the option legs
    at intrinsic value (the reference's per-period calc_options_series
    convention, app.py:182-193, applied to simulated prices), and candidates
    compound the hedged growth ``V_{t+1} = V_t · (1 + w'r_hedged_t)`` — the
    rebalanced R·w semantics. Buy-and-hold of an intrinsic-settled option
    position is not well-defined mid-path, so hedged scoring is always this
    settled recursion."""
    from mcport.options.hedged import hedged_step_returns

    paths = simulate_log_paths(key, mean_step, chol_step, n_paths, n_steps, dtype=dtype,
                               t_df=t_df)
    s0 = jnp.asarray(s0, dtype)
    prices = s0 * jnp.exp(paths)                              # (P, T, A)
    p0 = jnp.broadcast_to(s0, (n_paths, 1, s0.shape[-1]))
    full = jnp.concatenate([p0, prices], axis=1)              # (P, T+1, A)
    r_h = hedged_step_returns(full[:, :-1], full[:, 1:], h_t, h_k, h_p, h_q)
    f = 1.0 + jnp.einsum("pta,wa->wpt", r_h, w)               # per-step factors
    v = jnp.cumprod(f, axis=2)
    ones = jnp.ones(v.shape[:2] + (1,), dtype)
    v = jnp.concatenate([ones, v], axis=2)
    peak = jax.lax.cummax(v, axis=2)
    dd = jnp.min(v / peak - 1.0, axis=2)                      # (W, P)
    term = v[:, :, -1] - 1.0
    return term, dd


@partial(
    jax.jit,
    static_argnames=("n_candidates", "n_paths", "n_steps", "alpha", "w_block",
                     "use_pallas", "dtype", "trivial_bounds", "score_dtype",
                     "rebalance", "hedged", "t_df", "bm"),
)
def _score(
    key, mean_step, chol_step, min_w, max_w,
    n_candidates: int, n_paths: int, n_steps: int, alpha: float,
    w_block: int, use_pallas: bool, dtype, trivial_bounds: bool = False,
    score_dtype: str = "float32",
    rebalance: bool = False, hedged: bool = False, hedge_args: tuple = (),
    t_df: float | None = None, bm: str = "poly",
):
    k_path_seed, k_w = jax.random.split(key)
    if trivial_bounds:
        _, sub = jax.random.split(k_w)
        w, valid = _sample_unconstrained(sub, n_candidates, min_w.shape[-1])
    else:
        w, valid = sample_constrained_weights(k_w, n_candidates, min_w, max_w)
    w = w.astype(dtype)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))

    block = min(w_block, n_candidates)
    n_pad = -(-n_candidates // block) * block
    w_pad = jnp.pad(w, ((0, n_pad - n_candidates), (0, 0)))

    def chunk(w_blk):
        if hedged and not use_pallas:
            term, dd = _lax_multi_dd_hedged(
                k_path_seed, mean_step.astype(dtype), chol_step.astype(dtype),
                w_blk, n_paths, n_steps, dtype, *hedge_args, t_df=t_df,
            )
        elif use_pallas:
            from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

            seed = jax.random.randint(k_path_seed, (), 0, 1 << 30)
            term, dd = gbm_multi_portfolio_dd(
                seed, mean_step, chol_step, w_blk, n_paths, n_steps,
                score_dtype=score_dtype,
                rebalance=rebalance,
                hedge_args=hedge_args if hedged else None, t_df=t_df, bm=bm,
            )
        else:
            term, dd = _lax_multi_dd(
                k_path_seed, mean_step.astype(dtype), chol_step.astype(dtype),
                w_blk, n_paths, n_steps, dtype, rebalance, t_df,
            )
        ret = term.mean(axis=1)
        worst_dd, _ = jax.lax.top_k(-dd, k_tail)              # (B, k) biggest drawdowns
        dd_p95 = -worst_dd[:, -1]
        return ret, dd_p95

    ret, dd_p95 = jax.lax.map(chunk, w_pad.reshape(-1, block, w.shape[-1]))
    return w, valid, ret.reshape(-1)[:n_candidates], dd_p95.reshape(-1)[:n_candidates]


def drawdown_frontier_search(
    key: Array,
    params: GBMParams,
    dd_budget: float = 0.30,
    n_candidates: int = 4_096,
    n_paths: int = 8_192,
    n_steps: int = 252,
    alpha: float = 0.95,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    w_block: int = 128,
    dtype=jnp.float32,
    score_dtype: str = "auto",
    rescore_top: int = 32,
    use_pallas: bool | None = None,
    rebalance: bool = False,
    hedge=None,
    t_df: float | None = None,
    auto_bf16_min_work: int = 1 << 25,
    bm: str = "poly",
) -> DrawdownFrontierResult:
    """Max expected simulated return s.t. the p95-worst drawdown >= -dd_budget.

    Every candidate chunk sees the SAME simulated paths (shared path key), so
    candidate comparisons are exact, not noisy across chunks.

    ``score_dtype="bfloat16"`` screens candidates with bf16 operands in the
    fused kernel's scoring product, then re-scores the ``rescore_top``
    highest-return bf16-feasible candidates (plus any within one bf16 dd ulp
    of the budget) at f32 over the SAME paths, so the reported optimum and its
    metrics are exact f32. ``use_pallas=None`` picks the kernel by platform
    (:func:`mcport.ops.dispatch.use_kernels`).

    ``score_dtype="auto"`` (default, round 4) turns the bf16 screen ON when
    it is provably exact-at-the-optimum AND worth its extra rescore dispatch:
    buy-and-hold unhedged kernel scoring (terminal returns are bit-exact
    under bf16 — only drawdowns perturb, and every candidate the argmax could
    select lands in the rescore pool, so the reported optimum matches a
    full-f32 search, pinned by tests; the only residual ambiguity is
    candidates whose mean returns tie within ~1 ulp of the cross-program
    reduction — those are rescored and the argmax taken on exact values, so
    the auto winner is exact-optimal even then) with at least ``auto_bf16_min_work``
    candidate-path-steps (2^25 default — below that the f32 screen is already
    sub-millisecond on the device and the extra dispatch dominates).
    Rebalanced/hedged scoring compounds bf16 rounding through the terminal
    return itself, so auto never picks bf16 there — pass
    ``score_dtype="bfloat16"`` explicitly for those (metrics at the optimum
    are still exact f32; winner identity is then only margin-protected).

    ``rebalance=True`` scores per-period-rebalanced candidates
    (V_{t+1} = V_t · w'exp(x_t), the reference's historical R·w convention)
    instead of buy-and-hold; same kernel cost. Under bf16 screening the
    rebalanced recursion compounds rounding (~sqrt(T)·1e-3), so the rescore
    margin widens accordingly.

    ``t_df`` scores candidates under unit-variance Student-t shocks (fat
    tails, same per-step covariance) in every mode — kernel, lax, hedged,
    and the exact rescore pass.

    ``bm="poly_fast"`` (kernel path only; lax ignores it) swaps in the
    screening-tier normal draws (pallas_gbm._boxmuller_poly_fast,
    |Δz| <= ~1.5e-4) for BOTH the screen and the f32 winner rescore, so
    the rescore stays stream-consistent and the reported optimum remains
    exact-optimal *for the poly_fast draw stream*. The stream differs from
    the "poly" default (results shift by MC-noise-sized amounts), so this
    is an explicit screening opt-in, never picked by "auto".
    """
    a = params.n_assets
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)
    use_pallas = use_kernels(use_pallas)

    if score_dtype == "auto":
        work = n_candidates * n_paths * n_steps
        score_dtype = "bfloat16" if (
            use_pallas and rescore_top > 0 and not rebalance and hedge is None
            and work >= auto_bf16_min_work) else "float32"

    trivial = bool((np.asarray(min_w) <= 0).all() and (np.asarray(max_w) >= 1).all())
    mean_j, chol_j = jnp.asarray(params.mean_step), jnp.asarray(params.chol_step)
    hedge_args = () if hedge is None else (
        jnp.asarray(params.s0, dtype), *hedge.arrays)
    w, valid, ret, dd_p95 = _score(
        key, mean_j, chol_j,
        min_w, max_w, n_candidates, n_paths, n_steps, alpha, w_block, use_pallas,
        dtype, trivial, score_dtype if use_pallas else "float32",
        rebalance, hedge is not None, hedge_args, t_df, bm,
    )
    w, valid = np.asarray(w), np.asarray(valid)
    ret, dd_p95 = np.array(ret), np.array(dd_p95)   # writable: rescore updates
    budget = abs(dd_budget)

    if use_pallas and score_dtype == "bfloat16" and rescore_top > 0:
        # exact pass over the candidates bf16 screening could have misjudged:
        # those within `margin` of the budget (bf16 dd perturbation can flip
        # them; rebalance mode compounds rounding as ~sqrt(T) random walk).
        # The margin is the test-pinned perturbation bound from the kernel
        # module, so it cannot drift below what the tests allow the screen to
        # err by. Any candidate the final argmax can select is inside this
        # pool (the feasible set is a subset of it), so the loop below
        # rescored-batches until the WINNER itself is exact — the guarantee
        # holds even when more than rescore_top candidates crowd the band.
        from mcport.ops.pallas_multi_dd import (
            BF16_DD_ERR_BOUND, BF16_DD_ERR_REBAL_COEF,
        )
        # hedged scoring compounds per-step like rebalance mode: same widening
        margin = BF16_DD_ERR_BOUND + (
            BF16_DD_ERR_REBAL_COEF * math.sqrt(n_steps)
            if (rebalance or hedge is not None) else 0.0)
        pool = np.nonzero(valid & (dd_p95 >= -(budget + margin)))[0]
        if pool.size:
            from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

            k_path_seed, _ = jax.random.split(key)
            seed = jax.random.randint(k_path_seed, (), 0, 1 << 30)
            k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))
            rescored: set[int] = set()
            while True:
                feas = valid & (dd_p95 >= -budget)
                if not feas.any():
                    break
                winner = int(np.argmax(np.where(feas, ret, -np.inf)))
                if winner in rescored:
                    # near-tie contenders: ret is a cross-compiled-program
                    # mean reduction, so two programs can disagree by ~1 ulp
                    # (~1e-7 relative). Rescore any
                    # feasible candidate within that band of the (exact)
                    # winner so the final argmax compares exact values.
                    tie = 4e-7 * max(1.0, abs(float(ret[winner])))
                    ties = [i for i in np.nonzero(feas)[0]
                            if i not in rescored
                            and ret[i] >= ret[winner] - tie]
                    if not ties:
                        break
                    batch = np.asarray(ties[:max(rescore_top, 1)])
                else:
                    fresh = [i for i in pool[np.argsort(-ret[pool])]
                             if i != winner and i not in rescored]
                    batch = np.asarray([winner] + fresh[:rescore_top - 1])
                term_x, dd_x = gbm_multi_portfolio_dd(
                    seed, mean_j, chol_j, jnp.asarray(w[batch]), n_paths,
                    n_steps, rebalance=rebalance,
                    hedge_args=hedge_args if hedge is not None else None,
                    t_df=t_df, bm=bm,
                )
                ret[batch] = np.asarray(term_x.mean(axis=1))
                worst, _ = jax.lax.top_k(-dd_x, k_tail)
                dd_p95[batch] = np.asarray(-worst[:, -1])
                rescored.update(int(i) for i in batch)

    feasible = valid & (dd_p95 >= -budget)
    opt_idx = int(np.argmax(np.where(feasible, ret, -np.inf))) if feasible.any() else -1
    return DrawdownFrontierResult(
        weights=w, valid=valid, ret=ret, dd_p95=dd_p95, feasible=feasible,
        opt_idx=opt_idx, dd_budget=budget,
    )


@partial(jax.jit, static_argnames=("n_candidates", "trivial_bounds"))
def _sample_candidates(key, min_w, max_w, n_candidates: int,
                       trivial_bounds: bool):
    if trivial_bounds:
        _, sub = jax.random.split(key)
        return _sample_unconstrained(sub, n_candidates, min_w.shape[-1])
    return sample_constrained_weights(key, n_candidates, min_w, max_w)


def family_drawdown_frontier_search(
    key: Array,
    model: str,
    model_params,
    dd_budget: float = 0.30,
    n_candidates: int = 4_096,
    n_paths: int = 8_192,
    n_steps: int = 252,
    alpha: float = 0.95,
    min_weights: np.ndarray | None = None,
    max_weights: np.ndarray | None = None,
    w_block: int = 128,
    p_restart: float = 0.2,
    hedge=None,
    s0: np.ndarray | None = None,
) -> DrawdownFrontierResult:
    """Drawdown-constrained frontier under non-GBM path families.

    The GARCH / bootstrap counterpart of :func:`drawdown_frontier_search`:
    max expected simulated return s.t. the p95-worst max drawdown stays
    above ``-dd_budget``, with candidates scored by the per-period
    REBALANCED wealth recursion (the families' natural semantics — their
    paths are simple-return recursions, app.py:710; jump paths compound
    ``w'exp(x_t)``). ``model`` is "garch" (``model_params`` a
    :class:`mcport.models.garch_mc.CCCGarchParams` — volatility-clustered
    frontier), "dcc" (``model_params`` a
    :class:`mcport.models.dcc.DCCGarchParams` — dynamic-correlation
    frontier), "jump" (``model_params`` a
    :class:`mcport.models.jump.MertonParams` — systemic-crash frontier),
    "heston" (``model_params`` a :class:`mcport.models.heston.HestonParams`
    — stochastic-volatility frontier) or
    "bootstrap" (``model_params`` the (T, A) historical return matrix —
    distribution-free frontier; ``p_restart`` sets the expected block
    length).

    Candidate chunks share the per-chunk path stream (same seed → same
    paths for every chunk), so cross-chunk comparisons are exact. Scoring
    runs each family's lax path-stats form at f32 — no bf16 screening tier
    here.

    ``hedge`` (a HedgeSpec) + ``s0`` (current asset prices) switch every
    candidate to hedged per-period option settlement against the simulated
    price path.
    """
    if model not in ("garch", "dcc", "jump", "heston", "bootstrap"):
        raise ValueError(
            f"model must be 'garch', 'dcc', 'jump', 'heston' or 'bootstrap', "
            f"got {model!r}")
    if hedge is not None and s0 is None:
        raise ValueError("hedged family frontier requires s0 (asset prices)")
    if model == "garch":
        a = model_params.mu.shape[-1]
    elif model == "dcc":
        a = model_params.base.mu.shape[-1]
    elif model in ("jump", "heston"):
        a = model_params.n_assets
    else:
        history = jnp.asarray(model_params, jnp.float32)
        a = history.shape[-1]
    min_w = jnp.zeros(a) if min_weights is None else jnp.asarray(min_weights)
    max_w = jnp.ones(a) if max_weights is None else jnp.asarray(max_weights)
    trivial = bool((np.asarray(min_w) <= 0).all() and (np.asarray(max_w) >= 1).all())
    hedge_args = None if hedge is None else (
        jnp.asarray(s0, jnp.float32), *hedge.arrays)

    k_path, k_w = jax.random.split(key)
    w, valid = _sample_candidates(k_w, min_w, max_w, n_candidates, trivial)
    w = np.asarray(w.astype(jnp.float32))
    seed = jax.random.randint(k_path, (), 0, 1 << 30)
    path_key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))

    def score_chunk(w_blk):
        if model == "garch":
            from mcport.models.garch_mc import garch_path_stats

            term, dd = garch_path_stats(
                path_key, model_params, w_blk, n_paths, n_steps,
                hedge_args=hedge_args)
        elif model == "dcc":
            from mcport.models.dcc import dcc_path_stats

            term, dd = dcc_path_stats(
                path_key, model_params, w_blk, n_paths, n_steps,
                hedge_args=hedge_args)
        elif model == "jump":
            from mcport.models.jump import merton_path_stats

            mp = model_params
            term, dd = merton_path_stats(
                path_key, mp.diffusion.mean_step, mp.diffusion.chol_step,
                mp.jump_rate, mp.jump_mean, mp.jump_vol, w_blk,
                n_paths, n_steps, hedge_args=hedge_args)
        elif model == "heston":
            from mcport.models.heston import heston_path_stats

            term, dd = heston_path_stats(
                path_key, model_params, w_blk, n_paths, n_steps,
                hedge_args=hedge_args)
        else:
            from mcport.models.bootstrap import bootstrap_path_stats

            term, dd = bootstrap_path_stats(
                path_key, history, w_blk, n_paths, n_steps,
                p_restart=p_restart, hedge_args=hedge_args)
        ret = term.mean(axis=1)
        worst, _ = jax.lax.top_k(-dd, k_tail)
        return np.asarray(ret), np.asarray(-worst[:, -1])

    block = min(w_block, n_candidates)
    rets, dds = [], []
    for i in range(0, n_candidates, block):
        r_c, d_c = score_chunk(w[i:i + block])
        rets.append(r_c)
        dds.append(d_c)
    ret = np.concatenate(rets)
    dd_p95 = np.concatenate(dds)
    valid = np.asarray(valid)
    budget = abs(dd_budget)
    feasible = valid & (dd_p95 >= -budget)
    opt_idx = int(np.argmax(np.where(feasible, ret, -np.inf))) if feasible.any() else -1
    return DrawdownFrontierResult(
        weights=w, valid=valid, ret=ret, dd_p95=dd_p95, feasible=feasible,
        opt_idx=opt_idx, dd_budget=budget,
    )
