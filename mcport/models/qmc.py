"""Quasi-Monte-Carlo point sets for variance reduction (BASELINE.json:11).

Two generators feed the exact-terminal GBM sampler
(:func:`mcport.models.gbm.terminal_log_returns_exact` semantics — dims = assets):

- **Halton** — pure-JAX radical-inverse with Cranley-Patterson random rotation;
  fully on-device, arbitrary dimension (first 64 primes embedded), jit-able.
- **Sobol** — ``scipy.stats.qmc.Sobol`` (Joe-Kuo direction numbers, Owen
  scrambling) generated host-side; QMC point generation is a data-loader-tier
  cost next to path simulation, so host generation + one transfer is the right
  host/device split and avoids re-deriving direction-number tables.

Uniforms map to standard normals via the inverse normal CDF (``ndtri``), which
preserves the low-discrepancy structure (unlike Box-Muller).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["halton", "sobol", "qmc_normals", "PRIMES_64"]

# First 64 primes — Halton bases for up to 64 dimensions.
PRIMES_64 = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
    73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
    157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
    239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311,
)


def _radical_inverse(i: Array, base: int, n_digits: int, dtype) -> Array:
    """Vectorized van der Corput radical inverse in ``base`` (statically unrolled)."""
    inv = jnp.zeros(i.shape, dtype)
    f = jnp.asarray(1.0 / base, dtype)
    for _ in range(n_digits):
        inv = inv + (i % base).astype(dtype) * f
        i = i // base
        f = f / base
    return inv


@partial(jax.jit, static_argnames=("n", "dim", "dtype"))
def halton(key: Array | None, n: int, dim: int, dtype=jnp.float32) -> Array:
    """(n, dim) scrambled-Halton points in (0, 1).

    ``key=None`` gives the raw (unrotated) sequence; with a key, each dimension
    gets a Cranley-Patterson rotation ``(u + shift) mod 1`` so independent
    randomizations allow unbiased error estimation.
    """
    if dim > len(PRIMES_64):
        raise ValueError(f"halton supports up to {len(PRIMES_64)} dims, got {dim}")
    idx = jnp.arange(1, n + 1, dtype=jnp.uint32)  # skip the all-zero point
    cols = []
    for d in range(dim):
        b = PRIMES_64[d]
        n_digits = int(np.ceil(np.log(n + 1) / np.log(b))) + 1
        cols.append(_radical_inverse(idx, b, n_digits, dtype))
    u = jnp.stack(cols, axis=1)
    if key is not None:
        shift = jax.random.uniform(key, (dim,), dtype)
        u = jnp.mod(u + shift, 1.0)
    return u


def sobol(seed: int, n: int, dim: int, dtype=np.float32) -> np.ndarray:
    """(n, dim) Owen-scrambled Sobol points (host-side scipy; Joe-Kuo numbers).

    n is rounded up to the next power of two internally (Sobol balance), then
    truncated — pass power-of-two n for best discrepancy.
    """
    from scipy.stats import qmc  # lazy; scipy is baked in

    eng = qmc.Sobol(d=dim, scramble=True, rng=np.random.default_rng(seed))
    m = int(np.ceil(np.log2(max(n, 2))))
    pts = eng.random_base2(m)[:n]
    return pts.astype(dtype)


def qmc_normals(
    n: int,
    dim: int,
    method: str = "sobol",
    seed: int = 0,
    dtype=jnp.float32,
) -> Array:
    """(n, dim) standard normals from a low-discrepancy point set via ndtri."""
    if method == "halton":
        u = halton(jax.random.key(seed), n, dim, dtype)
    elif method == "sobol":
        u = jnp.asarray(sobol(seed, n, dim), dtype)
    else:
        raise ValueError(f"unknown QMC method {method!r}; expected sobol|halton")
    tiny = jnp.finfo(dtype).tiny
    u = jnp.clip(u, tiny, 1.0 - jnp.finfo(dtype).epsneg)
    return jax.scipy.special.ndtri(u).astype(dtype)
