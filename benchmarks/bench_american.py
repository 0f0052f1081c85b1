"""American LSMC tier throughput on one GPU.

Measures the two compiled cores of mcport/options/american.py at analysis
scale (15 options x 131072 paths x 252 steps, the headline-universe shape):

- ``_run_batch`` — the LSMC fit itself (forward sim + backward regression
  scan; per step one (N,4) basis matmul + 4x4 solve). Throughput is quoted
  in SIMULATED path-steps/s (A*N*T / wall) — the backward pass roughly
  doubles the work per path-step relative to a plain terminal kernel, so
  compare against the lax GBM tier, not the fused kernels.
- ``_greeks_batch`` — policy-frozen pathwise delta/vega (reverse-mode AD
  through the stopped-path scan; the backward sweep re-plays the simulation,
  so the AD constant matters).

Same-process difference timing (utils/profiling.diff_timed) with data-chained
seeds; ~1 s reps, so k=2 windows x 3 trials sit far above the sub-10ms noise
floor that forces k>=16 on the fleet's fast kernels.

    python benchmarks/bench_american.py          # needs a GPU
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

N_ASSETS = 15
N_PATHS = 131_072
N_STEPS = 252


def main():
    import jax
    import jax.numpy as jnp

    from mcport.options.american import _greeks_batch, _run_batch
    from mcport.utils.profiling import diff_timed, seed_chain

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (JAX platform {jax.default_backend()!r})")

    rng = np.random.default_rng(0)
    s0 = jnp.asarray(rng.uniform(50.0, 150.0, N_ASSETS), jnp.float32)
    sig = jnp.asarray(rng.uniform(0.015, 0.04, N_ASSETS), jnp.float32)
    k = s0 * 0.95
    put = jnp.ones(N_ASSETS, bool)
    r = 1.2e-4
    total = N_ASSETS * N_PATHS * N_STEPS

    float(jnp.zeros(()).sum())     # warm the transfer path

    @jax.jit
    def fit(seed):
        base = jax.random.fold_in(jax.random.key(0), seed)
        v, se, b, lo, hi = _run_batch(base, s0, sig, k, put, r, 0.0,
                                      N_PATHS, N_STEPS, True)
        return v.sum() * 1e-9

    t0 = time.perf_counter()
    float(fit(jnp.int32(0)))
    print(f"lsmc fit first call {time.perf_counter() - t0:.1f}s", flush=True)
    wall = diff_timed(seed_chain(fit), k=2, trials=3)
    print(f"lsmc_fit: {total / wall / 1e9:6.2f}e9 sim-path-steps/s "
          f"({wall:.2f}s per {N_ASSETS}x{N_PATHS}x{N_STEPS} fit)",
          flush=True)

    # a fitted threshold matrix (values are irrelevant to throughput)
    thr = jnp.asarray(
        np.linspace(0.75, 0.98, N_STEPS - 1)[None, :]
        * np.asarray(k)[:, None], jnp.float32)

    @jax.jit
    def greeks(seed):
        base = jax.random.fold_in(jax.random.key(1), seed)
        v, d, vg, se = _greeks_batch(base, s0, sig, thr, k, put, r, 0.0,
                                     N_PATHS, N_STEPS, True)
        return (v.sum() + d.sum()) * 1e-9

    t0 = time.perf_counter()
    float(greeks(jnp.int32(0)))
    print(f"greeks first call {time.perf_counter() - t0:.1f}s", flush=True)
    wall = diff_timed(seed_chain(greeks), k=2, trials=3)
    print(f"greeks:   {total / wall / 1e9:6.2f}e9 sim-path-steps/s "
          f"({wall:.2f}s per batch delta+vega)", flush=True)


if __name__ == "__main__":
    main()
