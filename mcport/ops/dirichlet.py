"""Batched constraint-respecting Dirichlet weight sampling.

The reference draws each candidate portfolio with up to 100 rejection retries in a
Python loop (app.py:699-707); candidates that never satisfy the per-asset min/max
weight bounds are silently skipped, so the simulation can yield fewer than
n_portfolios points (SURVEY.md §2 "rejection-sampling fallthrough").

Device design: draw the whole (N, A) batch at once from Dirichlet(1) and run a
``lax.while_loop`` that re-draws only the still-invalid rows, up to the same retry
budget. Control flow is compiler-friendly (no data-dependent Python loops), exits
after one round in the common unconstrained case, and the returned validity mask
carries the reference's skip semantics explicitly instead of by omission.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

__all__ = ["sample_constrained_weights", "sample_weights", "constraint_mask"]


def constraint_mask(weights: Array, min_w: Array, max_w: Array) -> Array:
    """(N,) bool — rows satisfying per-asset bounds (app.py:703)."""
    return jnp.all(weights >= min_w, axis=-1) & jnp.all(weights <= max_w, axis=-1)


def _dirichlet1(key: Array, n: int, a: int, dtype=jnp.float32) -> Array:
    """Dirichlet(1, ..., 1) (uniform on the simplex) via normalized
    Exponential(1) draws — the exact same law as ``jax.random.dirichlet`` with
    unit alpha, but without the general gamma rejection sampler's internal
    while_loops (a large compile-time and runtime cost at millions of rows;
    VERDICT r1 item 3)."""
    e = jax.random.exponential(key, (n, a), dtype)
    return e / e.sum(axis=-1, keepdims=True)


@partial(jax.jit, static_argnames=("n", "max_retries"))
def sample_constrained_weights(
    key: Array,
    n: int,
    min_w: Array,
    max_w: Array,
    max_retries: int = 100,
) -> tuple[Array, Array]:
    """Draw n simplex weight vectors under per-asset bounds.

    Returns ``(weights (n, A), valid (n,) bool)``. Invalid rows are rows that never
    passed within ``max_retries`` re-draws — the reference drops them
    (app.py:706-707); callers here must mask them out of optima instead.

    Draws are Threefry counter-based, so the batch is reproducible and splittable.
    """
    min_w = jnp.asarray(min_w)
    max_w = jnp.asarray(max_w)
    a = min_w.shape[-1]

    def draw(k: Array) -> Array:
        return _dirichlet1(k, n, a)

    key, sub = jax.random.split(key)
    w0 = draw(sub)
    valid0 = constraint_mask(w0, min_w, max_w)

    def cond(state):
        i, _key, _w, valid = state
        return (i < max_retries) & ~jnp.all(valid)

    def body(state):
        i, key, w, valid = state
        key, sub = jax.random.split(key)
        w_new = draw(sub)
        valid_new = constraint_mask(w_new, min_w, max_w)
        # keep already-valid rows; adopt fresh draws only where still invalid
        w = jnp.where(valid[:, None], w, w_new)
        valid = valid | valid_new
        return i + 1, key, w, valid

    # round 0 already happened; the loop spends the remaining retry budget
    _, _, w, valid = jax.lax.while_loop(cond, body, (1, key, w0, valid0))
    return w, valid


@partial(jax.jit, static_argnames=("n", "n_assets"))
def _sample_unconstrained(key: Array, n: int, n_assets: int) -> tuple[Array, Array]:
    return _dirichlet1(key, n, n_assets), jnp.ones((n,), bool)


def sample_weights(
    key: Array,
    n: int,
    min_w,
    max_w,
    max_retries: int = 100,
) -> tuple[Array, Array]:
    """Host-side dispatcher: skip the rejection while_loop when the bounds are
    the trivial [0, 1] box (every simplex point qualifies — the reference's
    default, app.py:453-454). Saves both the loop's compile time and a wasted
    constraint pass on large candidate counts. Bounds must be concrete here;
    traced callers (inside shard_map) use :func:`sample_constrained_weights`
    directly."""
    import numpy as np

    min_np, max_np = np.asarray(min_w), np.asarray(max_w)
    if (min_np <= 0).all() and (max_np >= 1).all():
        key, sub = jax.random.split(key)
        return _sample_unconstrained(sub, n, int(min_np.shape[-1]))
    return sample_constrained_weights(key, n, jnp.asarray(min_w), jnp.asarray(max_w),
                                      max_retries)
