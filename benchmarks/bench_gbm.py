"""BASELINE.json config 2: 15-asset Cholesky-correlated GBM, 100k paths x 252
steps — mean/vol/Sharpe from simulated terminals, plus kernel throughput.

Run: python benchmarks/bench_gbm.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from mcport.config import DataConfig, GBMConfig, SketchConfig
from mcport.data import load_universe
from mcport.engine.mc_engine import run_resumable_mc
from mcport.models import estimate_gbm
from mcport.utils.logging import RunLogger
from mcport.utils.profiling import diff_timed

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"


def main() -> None:
    log = RunLogger(stream=sys.stdout)
    backend = jax.default_backend()
    daily = sorted(p for p in FIXTURES.glob("*.csv") if "7 Years Weekly" not in p.name)
    d = load_universe(paths=daily, config=DataConfig(period="D"))
    params = estimate_gbm(d.prices)
    a = d.n_assets
    w = np.full(a, 1.0 / a)

    n_paths = 98_304 if backend == "gpu" else 16_384  # 12 x 8192 blocks (~100k)
    steps = 252
    cfg = GBMConfig(n_paths=n_paths, n_steps=steps, path_block=8_192)
    report, _ = run_resumable_mc(params, w, cfg, SketchConfig())
    ann_scale = 1.0  # steps are weekly periods here; report per-horizon stats
    port_vol_proxy = float(np.sqrt(w @ report.cov @ w))
    log.log("config2_gbm_stats", backend=backend, n_assets=a, n_paths=n_paths,
            steps=steps, port_mean=report.port_mean,
            port_log_vol=port_vol_proxy,
            sharpe_horizon=report.port_mean / max(port_vol_proxy, 1e-12),
            var95=report.var, cvar95=report.cvar)

    # kernel throughput via the difference protocol
    if backend == "gpu":
        from mcport.ops.pallas_gbm import pallas_terminal_log_returns

        m32 = params.mean_step.astype(np.float32)
        c32 = params.chol_step.astype(np.float32)
        bench_n = 1_048_576

        def loop(k):
            @jax.jit
            def run(seed0):
                def body(i, acc):
                    chain = jnp.int32(acc * 1e-6) & 7
                    return acc + pallas_terminal_log_returns(
                        seed0 + (i + 1) * (1 << 20) + chain, m32, c32, bench_n, steps
                    ).sum()
                return jax.lax.fori_loop(0, k, body, jnp.float32(0))
            return run(jnp.asarray(0, jnp.int32))

        per_rep = diff_timed(loop, k=4)
        log.log("config2_kernel_throughput", path_steps_per_sec=bench_n * steps / per_rep,
                vs_target=bench_n * steps / per_rep / 1e9)


if __name__ == "__main__":
    main()
