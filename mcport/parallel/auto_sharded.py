"""Compiler-parallelized weight search: jit + NamedSharding, no explicit collectives.

The shard_map engines in this package place every collective by hand; this module
demonstrates the other half of the JAX sharding recipe ("pick a mesh, annotate shardings,
let XLA insert collectives"): the candidate matrix is a global array sharded over
the mesh's candidate axis, the evaluation function is ordinary single-device
jnp code under ``jit``, and XLA's SPMD partitioner derives the parallel program —
the final ``argmax`` over the global metric vector becomes the cross-device
reduction automatically.

Numerically identical to evaluating unsharded (tested); useful as the simplest
scale-out path when the computation is a pure map over the sharded axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcport.engine.weight_search import evaluate_portfolios
from mcport.ops.dirichlet import sample_weights

__all__ = ["auto_sharded_weight_search"]


def auto_sharded_weight_search(
    key: Array,
    returns: np.ndarray,
    mean_ann: np.ndarray,
    cov_ann: np.ndarray,
    n_candidates: int,
    mesh: Mesh,
    min_weights: np.ndarray,
    max_weights: np.ndarray,
    risk_free: float = 0.0,
    alpha: float = 0.95,
    axis: str = "paths",
    dtype=jnp.float32,
) -> tuple[np.ndarray, float]:
    """Sharpe-max search with compiler-inserted parallelism.

    Candidates are sampled once (replicated draw for determinism), then the
    (N, A) matrix is placed with ``NamedSharding(mesh, P(axis, None))`` so every
    device owns a slice of rows; the jitted evaluation runs SPMD and the global
    argmax reduces across devices without any hand-written collective.
    """
    n_dev = mesh.shape[axis]
    if n_candidates % n_dev:
        raise ValueError(f"n_candidates {n_candidates} not divisible by {n_dev}")

    w, valid = sample_weights(key, n_candidates, min_weights, max_weights)
    w = w.astype(dtype)
    cand_sharding = NamedSharding(mesh, P(axis, None))
    mask_sharding = NamedSharding(mesh, P(axis))
    w = jax.device_put(w, cand_sharding)
    valid = jax.device_put(valid, mask_sharding)
    rep = NamedSharding(mesh, P())
    rets = jax.device_put(jnp.asarray(returns, dtype), rep)
    mu = jax.device_put(jnp.asarray(mean_ann, dtype), rep)
    sigma = jax.device_put(jnp.asarray(cov_ann, dtype), rep)

    @partial(jax.jit, out_shardings=(rep, rep))
    def search(w, valid, rets, mu, sigma):
        ev = evaluate_portfolios(w, rets, mu, sigma, risk_free, alpha)
        metric = jnp.where(valid, ev.sharpe, -jnp.inf)
        best = jnp.argmax(metric)          # XLA inserts the cross-device reduction
        return w[best], metric[best]

    best_w, best_m = search(w, valid, rets, mu, sigma)
    return np.asarray(best_w), float(best_m)
