"""Asset-axis scaling study (VERDICT r2 item 8).

The kernels pad assets to the next power of two, at least 16
(pallas_gbm.a_pad_for), with state laid out asset-major (A_pad, block). This measures terminal +
path-stats throughput at A = 7/15/31/63/127 to document the layout cliff:
per-step work is O(A_pad) for RNG/exp and O(A_pad^2) for the correlate
matmul, so path-steps/s (which normalizes by paths*steps, NOT assets) is
expected to fall roughly linearly in A_pad until the matmul's quadratic term
takes over. Tests pin correctness at the odd/padded sizes
(tests/test_kernel_twins.py, tests/test_pallas_gbm.py).

    python benchmarks/bench_scaling.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

N_PATHS = 262_144
N_STEPS = 252


def main():
    import jax
    import jax.numpy as jnp

    from mcport.ops import pallas_gbm
    from mcport.ops.pallas_gbm import gbm_path_stats, pallas_terminal_log_returns
    from mcport.utils.profiling import diff_timed

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU (JAX platform {jax.default_backend()!r})")

    rng = np.random.default_rng(0)
    print(f"{N_PATHS} paths x {N_STEPS} steps; rates in Gpath-steps/s "
          "(per-asset work scales with A_pad — see header)")
    print(f"{'A':>4} {'A_pad':>6} {'terminal':>9} {'path-stats':>10} "
          f"{'term*A_pad':>10} {'pstats*A_pad':>12}")
    for a in (7, 15, 31, 63, 127):
        corr = 0.5 * np.eye(a) + 0.5
        chol = np.linalg.cholesky(0.0004 * corr).astype(np.float32)
        mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
        w = rng.dirichlet(np.ones(a)).astype(np.float32)
        a_pad = pallas_gbm.a_pad_for(a)

        @jax.jit
        def term_one(seed, mean=mean, chol=chol):
            return pallas_terminal_log_returns(
                seed, mean, chol, N_PATHS, N_STEPS).sum() * 1e-9

        @jax.jit
        def ps_one(seed, mean=mean, chol=chol, w=w):
            t, p, d = gbm_path_stats(seed, mean, chol, w, N_PATHS, N_STEPS)
            return (p.sum() + d.sum()) * 1e-9

        def loop(one):
            def f(k):
                acc = jnp.float32(0)
                for i in range(k):
                    acc = acc + one(jnp.int32(1 + i) + (acc * 0).astype(jnp.int32))
                return acc
            return f

        # scale k so each rep batch is >~100 ms, far above timer noise
        k = max(4, int(64 // max(a_pad // 8, 1)))
        rt = N_PATHS * N_STEPS / diff_timed(loop(term_one), k=k) / 1e9
        rp = N_PATHS * N_STEPS / diff_timed(loop(ps_one), k=k) / 1e9
        print(f"{a:>4} {a_pad:>6} {rt:>9.2f} {rp:>10.2f} "
              f"{rt * a_pad:>10.0f} {rp * a_pad:>12.0f}")


if __name__ == "__main__":
    main()
