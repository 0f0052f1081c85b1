"""On-device streaming moments + mergeable quantile sketch.

Purpose (BASELINE.json:10): VaR/CVaR at 16M+ paths must reduce on device and across
chips without materializing all returns on one host. The reference's
``np.percentile`` (app.py:259) is exact but needs the full sample; here:

- :class:`MomentState` — count/sum/outer-product accumulators with **Neumaier
  compensation**: each accumulator carries a low-order correction term, and batch
  folds chunk the sample so per-chunk reductions stay short. The f32 accumulation
  error at 16.7M paths is then far below the 1e-6 moment-parity bar (BASELINE.json:5)
  without needing f64 (slow or absent on accelerators). An optional ``shift``
  (the analytically-known terminal drift) removes the ``E[x^2] - mean^2``
  cancellation from the covariance finalization. Mergeable by addition, so
  ``psum`` over a mesh gives the global moments (the psum itself adds one
  ~log2(n_dev) * eps rounding on the primary term — negligible next to
  within-device path counts).
- histogram sketch — fixed-bin counts over a configured range, in either linear
  return space or **log1p space** (``SketchConfig.space``). log1p space is the
  adaptive form: simple returns live in (-1, inf), so ``u = log1p(r)`` maps any
  return scale onto a bounded grid with *relative* price resolution — a weekly-BTC
  252-step horizon (terminal returns spanning -99%..+10000%) sketches as well as a
  one-year monthly one. :func:`auto_sketch` derives a guaranteed-covering range
  from the GBM parameters (±k_sigma per-asset terminal bounds), so nothing ever
  clamps into the edge bins. Counts are mergeable by addition (psum-able);
  quantiles and tail means interpolate within a bin, so the worst-case error is
  one bin width ((hi-lo)/n_bins in sketch space).

Both are pure jnp and work unchanged inside ``shard_map`` (see
:mod:`mcport.parallel.sharded_mc`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.config import SketchConfig

__all__ = [
    "MomentState",
    "init_moments",
    "update_moments",
    "merge_moments",
    "finalize_moments",
    "auto_sketch",
    "histogram",
    "sketch_quantile",
    "sketch_tail_mean",
    "sketch_var_cvar",
    "sketch_var_cvar_ci",
    "sketch_quantile_ci",
    "sample_var_cvar_ci",
    "tail_ci_fields",
]


class MomentState(NamedTuple):
    """Streaming first/second moments of an (n, A) sample stream.

    ``sum``/``outer`` are the primary accumulators; ``sum_c``/``outer_c`` are their
    Neumaier compensation terms (the accumulated low-order bits lost to rounding).
    The represented values are ``sum + sum_c`` and ``outer + outer_c``. All fields
    merge by plain addition, so a componentwise ``psum`` is a valid (near-exact)
    cross-device merge.
    """

    count: Array    # () float — number of samples seen
    sum: Array      # (A,)
    sum_c: Array    # (A,) compensation
    outer: Array    # (A, A) sum of x x'
    outer_c: Array  # (A, A) compensation


def init_moments(n_assets: int, dtype=jnp.float32) -> MomentState:
    z_a = jnp.zeros((n_assets,), dtype)
    z_aa = jnp.zeros((n_assets, n_assets), dtype)
    return MomentState(jnp.zeros((), dtype), z_a, z_a, z_aa, z_aa)


def _two_sum(s: Array, x: Array) -> tuple[Array, Array]:
    """Knuth/Neumaier branch-free two-sum: returns (fl(s+x), exact residual)."""
    t = s + x
    e = jnp.where(jnp.abs(s) >= jnp.abs(x), (s - t) + x, (x - t) + s)
    return t, e


def update_moments(
    state: MomentState, x: Array, shift: Array | None = None, chunk: int = 512
) -> MomentState:
    """Fold an (n, A) batch into the accumulator.

    The batch is split into ``chunk``-row sub-blocks; each sub-block reduces with
    one batched outer product, and sub-block results fold into the state through
    compensated adds. Short per-chunk reductions + exact cross-chunk accumulation
    keep the f32 error at 16.7M paths ~1e-9 relative (test_moment_scale.py).

    ``shift`` (A,) is subtracted from every sample before accumulation; pass the
    same value to :func:`finalize_moments`. Centering near E[x] makes the final
    covariance subtraction cancellation-free.
    """
    x = jnp.asarray(x, state.sum.dtype)
    n, a = x.shape
    if shift is not None:
        x = x - jnp.asarray(shift, x.dtype)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))  # zero rows are exact no-ops for sums
    xr = x.reshape(n_chunks, chunk, a)
    part_sums = xr.sum(axis=1)                        # (C, A)
    part_outers = jnp.einsum("cqa,cqb->cab", xr, xr)  # (C, A, A) batched matmul

    def fold(carry, part):
        s, sc, o, oc = carry
        ds, do = part
        s, e1 = _two_sum(s, ds)
        o, e2 = _two_sum(o, do)
        return (s, sc + e1, o, oc + e2), None

    (s, sc, o, oc), _ = jax.lax.scan(
        fold, (state.sum, state.sum_c, state.outer, state.outer_c),
        (part_sums, part_outers),
    )
    return MomentState(state.count + n, s, sc, o, oc)


def merge_moments(a: MomentState, b: MomentState) -> MomentState:
    """Associative compensated merge of two accumulators."""
    s, e1 = _two_sum(a.sum, b.sum)
    o, e2 = _two_sum(a.outer, b.outer)
    return MomentState(
        a.count + b.count, s, a.sum_c + b.sum_c + e1, o, a.outer_c + b.outer_c + e2
    )


def finalize_moments(
    state: MomentState, ddof: int = 1, shift: Array | None = None
) -> tuple[Array, Array]:
    """(mean (A,), cov (A, A)) with the reference's ddof=1 (app.py:680).

    ``shift`` must equal the one passed to :func:`update_moments` (it is added back
    to the mean; the covariance is shift-invariant).
    """
    n = state.count
    s = state.sum + state.sum_c
    m2 = state.outer + state.outer_c
    mean_c = s / n
    cov = (m2 - n * jnp.outer(mean_c, mean_c)) / (n - ddof)
    mean = mean_c if shift is None else mean_c + jnp.asarray(shift, s.dtype)
    return mean, cov


# ---- histogram sketch --------------------------------------------------------
#
# SketchConfig.space selects the binning coordinate:
#   "linear" — bins are uniform in return units over [lo, hi] (legacy behavior).
#   "log1p"  — bins are uniform in u = log1p(r); lo/hi are stored IN u-SPACE.
# Quantile/tail-mean results are always returned in return (value) space.

# floor must be representable in f32: -1 + 1e-12 rounds to exactly -1.0 there,
# letting log1p produce -inf whose int cast is backend-defined. -1 + 1e-6 is
# f32-exactly -0.999999 and maps to u = -13.8 — safely inside any sketch's
# bottom clamp.
_LOG1P_FLOOR = -1.0 + 1e-6


def _to_u(x: Array, config: SketchConfig) -> Array:
    if config.space == "log1p":
        return jnp.log1p(jnp.maximum(x, _LOG1P_FLOOR))
    return x


def _from_u(u: Array, config: SketchConfig):
    if config.space == "log1p":
        return jnp.expm1(u)
    return u


def auto_sketch(
    mean_step,
    chol_step,
    n_steps: int,
    weights=None,
    k_sigma: float = 12.0,
    n_bins: int = 8192,
    t_dof: float | None = None,
) -> SketchConfig:
    """Derive a guaranteed-covering log1p-space sketch from GBM parameters.

    Each asset's terminal log return is N(n*m_i, n*(LL')_ii); per-asset bounds at
    ±k_sigma (P[exceed] ~ 1e-33 at k=12) map through expm1, and a long-only
    portfolio return is a convex combination, so it is bracketed by the weighted
    (or worst-case, when ``weights`` is None) asset bounds regardless of
    correlation structure. The returned config can never clamp mass into the edge
    bins for the parameters it was built from (pinned by test_quantile_qmc).

    ``t_dof`` widens the range for Student-t innovations, whose tails are
    polynomial: the bound gains a single-extreme-shock term sized by the t
    quantile at ~1e-13 per draw (scipy isf), since one extreme per-step shock —
    not the Gaussian-ish sum — dominates the deep t tail.

    Host-side numpy on purpose: configs are static jit arguments.
    """
    m = np.asarray(mean_step, np.float64).reshape(-1)
    L = np.atleast_2d(np.asarray(chol_step, np.float64))
    var_step = np.einsum("ij,ij->i", L, L)  # diag of LL'
    mu = n_steps * m
    sd = np.sqrt(n_steps * var_step)
    widen = 0.0
    if t_dof is not None:
        from scipy.stats import t as _t

        # unit-variance single-shock quantile at 1e-13 (covers ~1e11 draws)
        x = float(_t.isf(1e-13, t_dof)) / np.sqrt(t_dof / (t_dof - 2.0))
        widen = x * np.sqrt(var_step)       # one extreme per-step shock
    lo_asset = np.expm1(mu - k_sigma * sd - widen)
    hi_asset = np.expm1(mu + k_sigma * sd + widen)
    if weights is None:
        lo_r, hi_r = float(lo_asset.min()), float(hi_asset.max())
    else:
        w = np.asarray(weights, np.float64).reshape(-1)
        lo_r, hi_r = float(w @ lo_asset), float(w @ hi_asset)
    lo_u = np.log1p(max(lo_r, _LOG1P_FLOOR))
    hi_u = np.log1p(hi_r)
    pad = 1e-6 * max(1.0, hi_u - lo_u)  # keep boundary samples strictly interior
    return SketchConfig(
        n_bins=n_bins, lo=float(lo_u - pad), hi=float(hi_u + pad), space="log1p"
    )


def histogram(x: Array, config: SketchConfig = SketchConfig(), dtype=jnp.float32) -> Array:
    """Bin a sample batch into (n_bins,) counts; out-of-range clamps to edge bins."""
    u = _to_u(jnp.asarray(x).reshape(-1), config)
    width = (config.hi - config.lo) / config.n_bins
    idx = jnp.clip(
        jnp.floor((u - config.lo) / width).astype(jnp.int32), 0, config.n_bins - 1
    )
    return jnp.zeros((config.n_bins,), dtype).at[idx].add(1.0)


def _edges(config: SketchConfig, dtype) -> tuple[Array, Array]:
    width = (config.hi - config.lo) / config.n_bins
    left = config.lo + width * jnp.arange(config.n_bins, dtype=dtype)
    return left, jnp.asarray(width, dtype)


def sketch_quantile(counts: Array, q: Array, config: SketchConfig = SketchConfig(),
                    total: Array | None = None) -> Array:
    """Quantile(s) from histogram counts, in return space, with within-bin linear
    interpolation (linear in sketch space).

    ``total`` overrides the mass normalizer. Importance-sampled (weighted)
    histograms MUST pass the exact expected mass (n draws: E[LR] = 1): the
    empirical sum of likelihood ratios is dominated by the few most-ordinary
    samples and is far noisier than the tail masses being quantiled."""
    counts = jnp.asarray(counts)
    q = jnp.asarray(q, counts.dtype)
    if total is None:
        total = counts.sum()
    cdf = jnp.cumsum(counts)
    target = q * total
    # first bin whose cumulative count reaches the target
    bin_idx = jnp.searchsorted(cdf, target, side="left")
    bin_idx = jnp.clip(bin_idx, 0, config.n_bins - 1)
    left, width = _edges(config, counts.dtype)
    below = jnp.where(bin_idx > 0, cdf[jnp.maximum(bin_idx - 1, 0)], 0.0)
    inbin = jnp.maximum(counts[bin_idx], 1.0)
    frac = jnp.clip((target - below) / inbin, 0.0, 1.0)
    return _from_u(left[bin_idx] + frac * width, config)


def sketch_tail_mean(counts: Array, thresh: Array, config: SketchConfig = SketchConfig()) -> Array:
    """Mean (in return space) of samples <= thresh, from the histogram.

    Each bin contributes its covered fraction at the midpoint of the covered
    sub-interval (mapped through the sketch-space transform), so the boundary bin
    is handled without bias; approximation error <= one bin width.
    """
    counts = jnp.asarray(counts)
    left, width = _edges(config, counts.dtype)
    u_t = _to_u(jnp.asarray(thresh, counts.dtype), config)
    # fraction of each bin below the threshold, in sketch space
    frac = jnp.clip((u_t - left) / width, 0.0, 1.0)
    mid = _from_u(left + 0.5 * frac * width, config)  # midpoint of the covered part
    tail_counts = counts * frac
    n_tail = tail_counts.sum()
    mean_tail = jnp.sum(tail_counts * mid) / jnp.maximum(n_tail, 1.0)
    return jnp.where(n_tail > 0, mean_tail, jnp.asarray(thresh, counts.dtype))


def sketch_var_cvar(
    counts: Array, alpha: float = 0.95, config: SketchConfig = SketchConfig()
) -> tuple[Array, Array]:
    """Historical-VaR/CVaR semantics of app.py:258-263 on sketched counts:
    VaR = quantile(1 - alpha), CVaR = mean of the tail at or below VaR."""
    v = sketch_quantile(counts, 1.0 - alpha, config)
    c = sketch_tail_mean(counts, v, config)
    return v, c


# Domain separation for bootstrap keys: simulation streams derive step/block
# keys via fold_in(key(seed), small_int) (and split(key, n)[i] == fold_in(key,
# i) in this JAX), so splitting the raw key(seed) would hand the first
# replicates exactly the keys that generated the sample's own draws. One
# fold_in with a large constant tag puts all bootstrap keys in a disjoint
# domain for any caller seed.
_CI_KEY_TAG = 0x63692D62  # "ci-b"


def _ci_keys(seed, n_boot: int):
    return jax.random.split(
        jax.random.fold_in(jax.random.key(seed), _CI_KEY_TAG), n_boot)


def tail_ci_fields(ci: dict) -> dict:
    """The error-bar fields of a *_ci result as plain floats (drops the point
    estimates — callers report those from their own exact computation)."""
    return {k: float(x) for k, x in ci.items() if k not in ("var", "cvar")}


@partial(jax.jit, static_argnames=("alpha", "config", "n_boot", "level"))
def sketch_var_cvar_ci(
    counts: Array,
    alpha: float = 0.95,
    config: SketchConfig = SketchConfig(),
    n_boot: int = 200,
    seed: int = 0,
    level: float = 0.95,
) -> dict:
    """Bootstrap confidence intervals for the sketched VaR/CVaR — every
    production risk number should carry its Monte-Carlo error bar.

    The engines never materialize the N per-path returns (that is the point
    of the sketch), so the resampling happens on the HISTOGRAM: each
    replicate draws ``counts_b ~ Multinomial(N, counts/N)`` — exactly the
    nonparametric bootstrap of the binned sample, with bin-resolution error
    already bounded by the sketch design (≤ one bin, ~1e-6 of the range).
    Multinomial draws factorize into a chain of binomials over bins
    (vmapped over replicates); quantile/tail-mean per replicate reuse the
    sketch machinery unchanged.

    Returns ``{"var", "cvar", "var_lo", "var_hi", "cvar_lo", "cvar_hi",
    "var_se", "cvar_se"}`` where lo/hi is the percentile-bootstrap
    ``level``-CI and se the replicate standard deviation. Resampling error
    of the CI itself shrinks as 1/sqrt(n_boot).
    """
    counts = jnp.asarray(counts, jnp.float32)
    v, c = sketch_var_cvar(counts, alpha, config)
    n = counts.sum()
    keys = _ci_keys(seed, n_boot)

    def one(k):
        cb = jax.random.multinomial(k, n, counts / n).astype(jnp.float32)
        vb = sketch_quantile(cb, 1.0 - alpha, config)
        return vb, sketch_tail_mean(cb, vb, config)

    vs, cs = jax.vmap(one)(keys)
    lo_q, hi_q = (1.0 - level) / 2.0, 1.0 - (1.0 - level) / 2.0
    qs = jnp.array([lo_q, hi_q], jnp.float32)
    v_ci = jnp.quantile(vs, qs)
    c_ci = jnp.quantile(cs, qs)
    return {
        "var": v, "cvar": c,
        "var_lo": v_ci[0], "var_hi": v_ci[1],
        "cvar_lo": c_ci[0], "cvar_hi": c_ci[1],
        "var_se": jnp.std(vs, ddof=1), "cvar_se": jnp.std(cs, ddof=1),
    }


@partial(jax.jit, static_argnames=("alpha", "n_boot", "level"))
def sample_var_cvar_ci(
    port: Array,
    alpha: float = 0.95,
    n_boot: int = 200,
    seed: int = 0,
    level: float = 0.95,
) -> dict:
    """Exact nonparametric bootstrap CI for the k-worst tail metrics of a
    MATERIALIZED (N,) portfolio-return sample (the exact-tier engines:
    hedged_tail_risk / compare_tail_risk) — resampled indices + top_k per
    replicate, the repo's ``k = ceil((1-alpha)N)`` convention
    (cvar_opt.exact_tail_metrics). Returns the same keys as
    :func:`sketch_var_cvar_ci`."""
    import math

    port = jnp.asarray(port, jnp.float32).reshape(-1)
    n = port.shape[0]
    k = max(1, math.ceil((1.0 - alpha) * n))
    worst, _ = jax.lax.top_k(-port, k)
    v, c = -worst[k - 1], -worst.mean()
    keys = _ci_keys(seed, n_boot)

    def one(key):
        idx = jax.random.randint(key, (n,), 0, n)
        wb, _ = jax.lax.top_k(-port[idx], k)
        return -wb[k - 1], -wb.mean()

    # sequential map, not vmap: vmap would materialize an (n_boot, n)
    # gathered copy (~13 GB at 16.7M paths x 200) for pure post-processing
    vs, cs = jax.lax.map(one, keys)
    lo_q, hi_q = (1.0 - level) / 2.0, 1.0 - (1.0 - level) / 2.0
    qs = jnp.array([lo_q, hi_q], jnp.float32)
    v_ci = jnp.quantile(vs, qs)
    c_ci = jnp.quantile(cs, qs)
    return {
        "var": v, "cvar": c,
        "var_lo": v_ci[0], "var_hi": v_ci[1],
        "cvar_lo": c_ci[0], "cvar_hi": c_ci[1],
        "var_se": jnp.std(vs, ddof=1), "cvar_se": jnp.std(cs, ddof=1),
    }


@partial(jax.jit, static_argnames=("q", "config", "n_boot", "level"))
def sketch_quantile_ci(
    counts: Array,
    q: float,
    config: SketchConfig = SketchConfig(),
    n_boot: int = 200,
    seed: int = 0,
    level: float = 0.95,
) -> dict:
    """Bootstrap CI for one sketched quantile (same multinomial-on-counts
    resampling as :func:`sketch_var_cvar_ci`); returns
    ``{"value", "lo", "hi", "se"}``."""
    counts = jnp.asarray(counts, jnp.float32)
    val = sketch_quantile(counts, q, config)
    n = counts.sum()
    keys = _ci_keys(seed, n_boot)

    def one(k):
        cb = jax.random.multinomial(k, n, counts / n).astype(jnp.float32)
        return sketch_quantile(cb, q, config)

    qs_b = jax.vmap(one)(keys)
    lo_q, hi_q = (1.0 - level) / 2.0, 1.0 - (1.0 - level) / 2.0
    ci = jnp.quantile(qs_b, jnp.array([lo_q, hi_q], jnp.float32))
    return {"value": val, "lo": ci[0], "hi": ci[1],
            "se": jnp.std(qs_b, ddof=1)}
