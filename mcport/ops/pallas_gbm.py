"""Fused Pallas kernels (Triton route) for correlated-GBM Monte Carlo.

The lax engines (:mod:`mcport.models.gbm`, :mod:`mcport.engine.path_risk`)
scan over time steps and carry ``(paths, A)`` state through device memory at
every step. These kernels keep each path block's state in registers for the
whole horizon and write once:

- :func:`gbm_terminal_noise` — terminal sampler. Uses ``sum_t(L z_t) =
  L (sum_t z_t)`` to hoist the Cholesky product out of the step loop: per
  step it draws and accumulates z, then correlates once. Returns the
  correlated noise sum so the wrapper forms ``drift + noise`` and the
  antithetic mirror ``drift - noise`` from one pass.
- :func:`gbm_path_stats` — full path evolution with one portfolio: per-step
  Cholesky product, running log price, portfolio value ``V_t = sum_a w_a
  exp(logS_a,t)``, running peak and maximum drawdown.

Layout: state is asset-major ``(A_pad, block)`` — assets on rows (padded to
the next power of two, at least 16, which is what ``pl.dot`` takes), paths
on columns. The grid is 1-D over independent path blocks; nothing is carried
between programs.

Random bits: :func:`threefry2x32` is Threefry-2x32 with 20 rounds written in
plain ``uint32`` jnp operations, so the compiled kernel, its interpreted form
and the plain-jnp twins (:func:`terminal_noise_reference`,
:func:`path_stats_reference`) draw identical bits. Draw ``i`` of path block
``b`` is the counter ``(i, row * block + lane)`` under the key ``(seed, b)``:
every block is an independent, re-derivable stream (checkpoint/resume only
needs the block index). One Threefry call yields both uniforms of a
Box-Muller pair.

Normals: Box-Muller with ``ln`` and ``sin/cos`` as FMA polynomials ("poly",
absolute error ~1e-7 per draw over the full uniform range) or the
degree-5 screening fits ("poly_fast", ``--fast-normal``, error <= ~1.5e-4).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import Array, lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mcport.ops.dispatch import kernel_interpret

__all__ = ["threefry2x32", "gbm_terminal_noise", "pallas_terminal_log_returns",
           "gbm_path_stats", "terminal_noise_reference", "path_stats_reference"]

_TWO_PI = 2.0 * math.pi

# Correlate and score dots run in IEEE float32 (no TF32): the Cholesky factor
# must not pick up a ~1e-3 relative perturbation.
F32 = lax.Precision.HIGHEST


def a_pad_for(a: int) -> int:
    """Rows for ``a`` assets: the next power of two, at least 16."""
    return max(16, 1 << (a - 1).bit_length())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Warps per program, chosen on an H100 with the path blocks below: terminal
# 128 paths / 4 warps, path-stats 64 paths / 2 warps (PERF.md, "Register
# budget").
_TERMINAL_WARPS = 4
_PATH_STATS_WARPS = 2


def compiler_params(num_warps: int) -> pl_triton.CompilerParams:
    # nothing is loaded inside the step loops, so there is nothing to pipeline
    return pl_triton.CompilerParams(num_warps=num_warps, num_stages=1)


# ---------------------------------------------------------------------------
# random bits
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1) -> tuple[Array, Array]:
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), on ``uint32`` operands.

    Bit-identical to ``jax.random``'s ``threefry_2x32`` on the key ``(k0,
    k1)`` and the counter pair ``(x0, x1)``; operands broadcast.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    ks = (k0, k1, k0 ^ k1 ^ jnp.uint32(0x1BD11BDA))
    x0 = jnp.asarray(x0, jnp.uint32) + ks[0]
    x1 = jnp.asarray(x1, jnp.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def _bits_to_unit(bits: Array) -> Array:
    """uint32 → float32 uniform in (0, 1]: the top 23 bits become the mantissa
    of a float in [1, 2), mapped to ``2 - r`` (strictly positive, safe under
    ``log``)."""
    one_to_two = lax.bitcast_convert_type(
        (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32)
    return 2.0 - one_to_two


def uniform_pair(seed, block, draw, shape) -> tuple[Array, Array]:
    """Two independent (0, 1] grids of ``shape`` for draw ``draw`` of path
    block ``block`` (counter ``(draw, row * cols + col)``, key ``(seed,
    block)``)."""
    cols = shape[1]
    elem = (lax.broadcasted_iota(jnp.int32, shape, 0) * cols
            + lax.broadcasted_iota(jnp.int32, shape, 1)).astype(jnp.uint32)
    y0, y1 = threefry2x32(
        jnp.asarray(seed, jnp.int32).astype(jnp.uint32),
        jnp.asarray(block, jnp.int32).astype(jnp.uint32),
        jnp.asarray(draw, jnp.int32).astype(jnp.uint32), elem)
    return _bits_to_unit(y0), _bits_to_unit(y1)


# ---------------------------------------------------------------------------
# normals from uniforms (FMA polynomials)
# ---------------------------------------------------------------------------

def _ln_poly(u: Array, coef=None) -> Array:
    """ln(u) for u in (2^-23, 1] via exponent extraction + FMA polynomial.
    Range reduction: u = m * 2^-e, m in [1, 2); fold m >= sqrt(2) down one
    octave so x = m' - 1 lies in [-0.293, 0.414]; ln u = ln(1+x) - e' ln 2.
    Max abs error ~1e-7 (degree-10 fit); ``coef`` swaps the fit (the
    "poly_fast" tier passes the degree-5 _LN1P_FAST_COEF, 5.7e-6)."""
    coef = _LN1P_COEF if coef is None else coef
    bits = lax.bitcast_convert_type(u, jnp.uint32)
    e = (bits >> jnp.uint32(23)).astype(jnp.int32) - 127     # u <= 1 → e <= 0
    m = lax.bitcast_convert_type(
        (bits & jnp.uint32(0x007FFFFF)) | jnp.uint32(0x3F800000), jnp.float32
    )                                                         # [1, 2)
    big = m >= 1.4142135
    m = jnp.where(big, 0.5 * m, m)
    ef = e.astype(jnp.float32) + jnp.where(big, 1.0, 0.0)
    x = m - 1.0
    p = coef[0]
    for c in coef[1:]:
        p = p * x + c
    return p * x + ef * 0.6931471805599453


# degree-10 Chebyshev fit of ln(1+x)/x on [sqrt(2)/2-1, sqrt(2)-1], highest
# coefficient first (Horner); max abs error of x*P(x) vs ln(1+x): 5.1e-8 in f32
_LN1P_COEF = (
    0.0665224252, -0.115752432, 0.118808561, -0.124213966, 0.142213354,
    -0.166670732, 0.200021019, -0.250000367, 0.333333095, -0.499999997, 1.0,
)

# degree-5 fit of the same function for the "poly_fast" screening tier:
# max abs err of x*P(x) vs ln(1+x) = 5.7e-6 on the reduced range
_LN1P_FAST_COEF = (
    -0.1416694926, 0.2181395213, -0.2536432665, 0.3327617641, -0.4999231513,
    1.0000028669,
)


def _sincos_poly(u: Array, fast: bool = False) -> tuple[Array, Array]:
    """(cos, sin)(2*pi*u) for u in [0, 1) via quadrant reduction + Taylor
    polynomials on [-pi/4, pi/4]. ``fast`` swaps in degree-5/4 Chebyshev fits
    (sin 2.5e-6 / cos 2.2e-5 max abs err) for the "poly_fast" tier."""
    t = 4.0 * u
    q = jnp.floor(t + 0.5)                              # 0..4
    r = (t - q) * (0.5 * math.pi)                       # [-pi/4, pi/4]
    r2 = r * r
    if fast:
        s = r * (0.9999990055 + r2 * (-0.1666327627 + r2 * 0.0081679515))
        c = 0.9999930664 + r2 * (-0.499763506 + r2 * 0.0405120397)
    else:
        # sin: odd Taylor to r^9; cos: even Taylor to r^8 (errs < 3e-8)
        s = r * (1.0 + r2 * (-1.0 / 6 + r2 * (1.0 / 120 + r2 * (-1.0 / 5040 + r2 / 362880))))
        c = 1.0 + r2 * (-0.5 + r2 * (1.0 / 24 + r2 * (-1.0 / 720 + r2 / 40320)))
    q = jnp.where(q == 4.0, 0.0, q)                     # wrap the top edge
    q1, q2, q3 = q == 1.0, q == 2.0, q == 3.0
    cos_t = jnp.where(q1, -s, jnp.where(q2, -c, jnp.where(q3, s, c)))
    sin_t = jnp.where(q1, c, jnp.where(q2, -s, jnp.where(q3, -c, s)))
    return cos_t, sin_t


def _boxmuller(u1: Array, u2: Array) -> tuple[Array, Array]:
    """Box-Muller with plain ``log``/``cos``/``sin``: the reference for the
    polynomial forms' per-draw error. Not a kernel tier: compiled through
    Triton's libdevice calls it ran the terminal kernel at 21.0 ms against
    12.0 ms for "poly" (1M paths x 252 steps x 15 assets, H100 80GB HBM3 at
    a 700 W power limit)."""
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = _TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def _boxmuller_poly(u1: Array, u2: Array) -> tuple[Array, Array]:
    """Box-Muller with ln and sincos as FMA polynomials. The exponent-
    extraction log is accurate to ~1e-7 absolute over the full (2^-23, 1]
    range, so tail draws keep full f32 fidelity."""
    r = jnp.sqrt(-2.0 * _ln_poly(u1))
    c, s = _sincos_poly(u2)
    return r * c, r * s


def _boxmuller_poly_fast(u1: Array, u2: Array) -> tuple[Array, Array]:
    """Screening-tier Box-Muller: degree-5 ln + degree-5/4 sincos fits. Draw
    error (law-tested in tests/test_pallas_gbm.py): z error <= 1e-5 +
    2.5e-5*r + 5.7e-6/r over the full representable uniform range — worst
    case ~1.5e-4 at the 5.65-sigma radius, <= 5e-5 in the body."""
    r = jnp.sqrt(-2.0 * _ln_poly(u1, _LN1P_FAST_COEF))
    c, s = _sincos_poly(u2, fast=True)
    return r * c, r * s


_BM_VARIANTS = {
    "poly": _boxmuller_poly,
    "poly_fast": _boxmuller_poly_fast,
}

_LOG2E = 1.4426950408889634
# degree-6 fit of 2^f on [-0.5, 0.5] in ln2 powers (exp(f ln2)), Horner
_EXP2_COEF = (
    0.000154653149, 0.00133952823, 0.00961803994, 0.0555034068, 0.240226511,
    0.6931472, 1.0,
)


def _exp_poly(x: Array) -> Array:
    """exp(x) via exponent split + FMA polynomial: x = (k + f) ln 2, k
    integer, f in [-0.5, 0.5]; exp(x) = 2^k * P(f). Rel err ~1e-7; k clamped
    to the normal-float range (underflow → ~0, like exp)."""
    t = x * _LOG2E
    k = jnp.floor(t + 0.5)
    f = t - k
    k = jnp.clip(k, -126.0, 127.0).astype(jnp.int32)
    scale = lax.bitcast_convert_type(
        ((k + 127) << 23).astype(jnp.uint32), jnp.float32)
    p = _EXP2_COEF[0]
    for c in _EXP2_COEF[1:]:
        p = p * f + c
    return p * scale


def shock_pair(seed, block, shape, bm: str = "poly", t_df: float | None = None):
    """``pair(i)`` → the two shock grids of draw pair ``i`` of path block
    ``block``: standard normals (Box-Muller tier ``bm``) or, with ``t_df``,
    Student-t draws (Bailey's polar form T = sqrt(df (u^(-2/df) - 1))
    cos(2 pi v), two uniforms each, so draw pair ``i`` takes counters 2i and
    2i+1)."""
    if t_df is None:
        boxmuller = _BM_VARIANTS[bm]

        def pair(i):
            return boxmuller(*uniform_pair(seed, block, i, shape))

        return pair

    neg2_over_df = -2.0 / t_df

    def one_t(u, v):
        p = _exp_poly(neg2_over_df * _ln_poly(u)) - 1.0
        r = jnp.sqrt(t_df * jnp.maximum(p, 0.0))
        c, _ = _sincos_poly(v)
        return r * c

    def pair(i):
        u1, v1 = uniform_pair(seed, block, 2 * i, shape)
        u2, v2 = uniform_pair(seed, block, 2 * i + 1, shape)
        return one_t(u1, v1), one_t(u2, v2)

    return pair


def paired_step_loop(pair, one_step, init, n_steps: int):
    """Run ``one_step(z, carry)`` ``n_steps`` times, drawing shocks two at a
    time (``pair(i)`` yields z_{2i}, z_{2i+1}); an odd last step uses the
    first grid of pair ``n_steps // 2``."""
    def body(i, carry):
        z1, z2 = pair(i)
        return one_step(z2, one_step(z1, carry))

    state = lax.fori_loop(0, n_steps // 2, body, init)
    if n_steps % 2:
        z1, _ = pair(jnp.int32(n_steps // 2))
        state = one_step(z1, state)
    return state


def correlate(lt: Array, z: Array) -> Array:
    """``L @ z`` in IEEE float32."""
    return jnp.dot(lt, z, precision=F32, preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# terminal-only sampler
# ---------------------------------------------------------------------------

def _terminal_block(seed, b, lt, *, n_steps, shape, bm, t_df):
    """Correlated noise sum ``L · sum_t z_t`` of path block ``b`` — the
    kernel body and the twin's per-block function."""
    pair = shock_pair(seed, b, shape, bm, t_df)
    acc = paired_step_loop(pair, lambda z, acc: acc + z,
                           jnp.zeros(shape, jnp.float32), n_steps)
    return correlate(lt, acc)


def _terminal_kernel(seed_ref, lt_ref, out_ref, **kw):
    out_ref[...] = _terminal_block(seed_ref[0], pl.program_id(0), lt_ref[...],
                                   shape=out_ref.shape, **kw)


def _padded_factor(chol_step, t_df):
    chol = jnp.asarray(chol_step, jnp.float32)
    if t_df is not None:
        # unit-variance t shocks: the 1/sqrt(df/(df-2)) scale folds into L
        chol = chol / jnp.sqrt(jnp.float32(t_df / (t_df - 2.0)))
    a = chol.shape[0]
    a_pad = a_pad_for(a)
    return jnp.zeros((a_pad, a_pad), jnp.float32).at[:a, :a].set(chol), a_pad


@functools.partial(
    jax.jit,
    static_argnames=("n_paths", "n_steps", "block", "interpret", "bm", "t_df"))
def gbm_terminal_noise(
    seed: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    block: int = 128,
    interpret: bool = False,
    bm: str = "poly",
    t_df: float | None = None,
) -> Array:
    """Correlated terminal noise ``L · sum_t z_t`` → (A_pad, n_pad) float32.

    The caller adds the drift. Path block ``b`` draws the stream keyed
    ``(seed, b)``, so any block can be regenerated on its own.
    """
    lt, a_pad = _padded_factor(chol_step, t_df)
    n_pad = _round_up(n_paths, block)
    return pl.pallas_call(
        functools.partial(_terminal_kernel, n_steps=n_steps, bm=bm, t_df=t_df),
        grid=(n_pad // block,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((a_pad, a_pad), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((a_pad, block), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((a_pad, n_pad), jnp.float32),
        backend="triton",
        compiler_params=compiler_params(_TERMINAL_WARPS),
        interpret=kernel_interpret(interpret),
        name="gbm_terminal_noise",
    )(jnp.asarray(seed).astype(jnp.int32).reshape(1), lt)


@functools.partial(
    jax.jit, static_argnames=("n_paths", "n_steps", "block", "bm", "t_df"))
def terminal_noise_reference(
    seed: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    block: int = 128,
    bm: str = "poly",
    t_df: float | None = None,
) -> Array:
    """Plain-jnp twin of :func:`gbm_terminal_noise`: the same draws and the
    same per-block function, vmapped over blocks outside any kernel."""
    lt, a_pad = _padded_factor(chol_step, t_df)
    n_blocks = _round_up(n_paths, block) // block
    seed = jnp.asarray(seed).astype(jnp.int32)
    out = jax.vmap(lambda b: _terminal_block(
        seed, b, lt, n_steps=n_steps, shape=(a_pad, block), bm=bm,
        t_df=t_df))(jnp.arange(n_blocks, dtype=jnp.int32))
    return out.transpose(1, 0, 2).reshape(a_pad, n_blocks * block)


def pallas_terminal_log_returns(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    n_paths: int,
    n_steps: int,
    antithetic: bool = False,
    block: int = 128,
    interpret: bool = False,
    t_df: float | None = None,
    bm: str = "poly",
    reference: bool = False,
) -> Array:
    """Terminal cumulative log returns (n_paths, A) — the kernel counterpart
    of :func:`mcport.models.gbm.terminal_log_returns` (or, with ``t_df``, of
    :func:`terminal_log_returns_t`: unit-variance Student-t shocks).

    With ``antithetic=True`` the second half of the paths mirrors the first
    half's noise (drift - noise), from one pass over n_paths/2 noise columns.
    ``bm="poly_fast"`` selects the screening-tier normals. ``reference=True``
    computes the same draws with the plain-jnp twin instead of the kernel.
    """
    m = jnp.asarray(mean_step, jnp.float32)
    a = m.shape[-1]
    half = n_paths // 2 if antithetic else n_paths
    if reference:
        noise = terminal_noise_reference(seed, chol_step, half, n_steps, block,
                                         bm=bm, t_df=t_df)
    else:
        noise = gbm_terminal_noise(seed, chol_step, half, n_steps, block,
                                   interpret=interpret, bm=bm, t_df=t_df)
    noise = noise[:a, :half].T                     # (half, A)
    drift = n_steps * m
    if antithetic:
        return jnp.concatenate([drift + noise, drift - noise], axis=0)
    return drift + noise


# ---------------------------------------------------------------------------
# full path evolution with path-dependent statistics (one portfolio)
# ---------------------------------------------------------------------------

def _path_stats_block(seed, b, m, lt, w, *, n_steps, shape, bm, t_df,
                      rebalance):
    """(terminal log prices (A_pad, block), portfolio terminal return
    (block,), max drawdown (block,)) of path block ``b``."""
    pair = shock_pair(seed, b, shape, bm, t_df)
    block = shape[1]

    def one_step(z, carry):
        acc, v, peak, dd = carry
        x = m + correlate(lt, z)                     # per-step log increment
        acc = acc + x
        if rebalance:
            # per-period rebalancing to the fixed weights (the reference's
            # historical-series semantics, app.py:710): V_{t+1} = V_t w'exp(x)
            v = v * jnp.sum(w * jnp.exp(x), axis=0)
        else:
            v = jnp.sum(w * jnp.exp(acc), axis=0)
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        return acc, v, peak, dd

    ones = jnp.ones((block,), jnp.float32)
    acc, v, _, dd = paired_step_loop(
        pair, one_step,
        (jnp.zeros(shape, jnp.float32), ones, ones,
         jnp.zeros((block,), jnp.float32)),
        n_steps)
    return acc, v - 1.0, dd


def _path_stats_kernel(seed_ref, m_ref, lt_ref, w_ref, term_ref, port_ref,
                       dd_ref, **kw):
    acc, port, dd = _path_stats_block(
        seed_ref[0], pl.program_id(0), m_ref[...], lt_ref[...], w_ref[...],
        shape=term_ref.shape, **kw)
    term_ref[...] = acc
    port_ref[...] = port
    dd_ref[...] = dd


def _padded_path_inputs(mean_step, chol_step, weights, t_df):
    lt, a_pad = _padded_factor(chol_step, t_df)
    m = jnp.asarray(mean_step, jnp.float32)
    w = jnp.asarray(weights, jnp.float32)
    a = m.shape[-1]
    m_pad = jnp.zeros((a_pad, 1), jnp.float32).at[:a, 0].set(m)
    w_pad = jnp.zeros((a_pad, 1), jnp.float32).at[:a, 0].set(w)
    return m_pad, lt, w_pad, a_pad


@functools.partial(
    jax.jit,
    static_argnames=("n_paths", "n_steps", "block", "interpret", "rebalance",
                     "t_df", "bm", "reference"))
def gbm_path_stats(
    seed: Array,
    mean_step: Array,
    chol_step: Array,
    weights: Array,
    n_paths: int,
    n_steps: int,
    block: int = 64,
    interpret: bool = False,
    rebalance: bool = False,
    t_df: float | None = None,
    bm: str = "poly",
    reference: bool = False,
) -> tuple[Array, Array, Array]:
    """Fused path evolution with portfolio statistics.

    Returns ``(terminal_log (n_paths, A), port_return (n_paths,), max_dd
    (n_paths,))`` for one weight vector: per-step Cholesky product, running
    peak and drawdown of ``V_t = sum_a w_a exp(logS_a,t)`` as the paths
    evolve. ``rebalance=True`` compounds ``V_{t+1} = V_t w'exp(x_t)``
    instead (per-period rebalancing).

    ``t_df`` swaps the shocks for unit-variance Student-t draws (the
    1/sqrt(df/(df-2)) scale folds into the Cholesky factor). ``bm="poly_fast"``
    selects the screening-tier normals (a different stream). ``reference=True``
    runs the plain-jnp twin on the same draws instead of the kernel.
    """
    m_pad, lt, w_pad, a_pad = _padded_path_inputs(mean_step, chol_step,
                                                  weights, t_df)
    a = jnp.shape(mean_step)[-1]
    n_pad = _round_up(n_paths, block)
    kw = dict(n_steps=n_steps, bm=bm, t_df=t_df, rebalance=rebalance)
    seed = jnp.asarray(seed).astype(jnp.int32)
    if reference:
        term, port, dd = jax.vmap(lambda b: _path_stats_block(
            seed, b, m_pad, lt, w_pad, shape=(a_pad, block), **kw))(
                jnp.arange(n_pad // block, dtype=jnp.int32))
        term = term.transpose(1, 0, 2).reshape(a_pad, n_pad)
        port, dd = port.reshape(n_pad), dd.reshape(n_pad)
    else:
        vec = pl.BlockSpec((a_pad, 1), lambda i: (0, 0))
        row = pl.BlockSpec((block,), lambda i: (i,))
        term, port, dd = pl.pallas_call(
            functools.partial(_path_stats_kernel, **kw),
            grid=(n_pad // block,),
            in_specs=[
                pl.BlockSpec((1,), lambda i: (0,)),
                vec,
                pl.BlockSpec((a_pad, a_pad), lambda i: (0, 0)),
                vec,
            ],
            out_specs=(pl.BlockSpec((a_pad, block), lambda i: (0, i)), row, row),
            out_shape=(
                jax.ShapeDtypeStruct((a_pad, n_pad), jnp.float32),
                jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            ),
            backend="triton",
            compiler_params=compiler_params(_PATH_STATS_WARPS),
            interpret=kernel_interpret(interpret),
            name="gbm_path_stats",
        )(seed.reshape(1), m_pad, lt, w_pad)
    return term[:a, :n_paths].T, port[:n_paths], dd[:n_paths]


def path_stats_reference(seed, mean_step, chol_step, weights, n_paths: int,
                         n_steps: int, block: int = 64, **kw):
    """Plain-jnp twin of :func:`gbm_path_stats` (same draws, no kernel)."""
    return gbm_path_stats(seed, mean_step, chol_step, weights, n_paths,
                          n_steps, block, reference=True, **kw)
