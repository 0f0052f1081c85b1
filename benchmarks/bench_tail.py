"""BASELINE.json config 4: tail risk at scale — 16M paths, VaR_95/99 + CVaR via
the on-device quantile sketch and the chunked resumable engine.

Run: python benchmarks/bench_tail.py  (16M paths on a GPU; 1M on the CPU)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from mcport.config import DataConfig, GBMConfig, SketchConfig
from mcport.data import load_universe
from mcport.engine.mc_engine import run_resumable_mc
from mcport.models import estimate_gbm
from mcport.utils.logging import RunLogger

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"


def main() -> None:
    log = RunLogger(stream=sys.stdout)
    backend = jax.default_backend()
    daily = sorted(p for p in FIXTURES.glob("*.csv") if "7 Years Weekly" not in p.name)
    d = load_universe(paths=daily, config=DataConfig(period="D"))
    params = estimate_gbm(d.prices)
    a = d.n_assets
    w = np.full(a, 1.0 / a)

    n_paths = 16_777_216 if backend == "gpu" else 1_048_576
    cfg = GBMConfig(n_paths=n_paths, n_steps=52, path_block=262_144,
                    antithetic=True)
    # adaptive log1p sketch derived from the GBM params (r2: replaces the fixed
    # linear grid that silently clamped long-horizon/crypto return scales)
    from mcport.ops.quantile import auto_sketch
    sketch = auto_sketch(params.mean_step, params.chol_step, cfg.n_steps,
                         n_bins=16_384)

    t0 = time.perf_counter()
    report, ck = run_resumable_mc(params, w, cfg, sketch, alpha=0.95)
    dt = time.perf_counter() - t0
    # VaR99 from the same sketch
    from mcport.ops.quantile import sketch_quantile
    import jax.numpy as jnp

    var99 = float(sketch_quantile(jnp.asarray(ck.hist), 0.01, sketch))
    log.log("config4_tail_risk", backend=backend, n_paths=n_paths, seconds=dt,
            sketch_space=sketch.space,
            paths_per_sec=n_paths / dt, var95=report.var, var99=var99,
            cvar95=report.cvar, port_mean=report.port_mean)


if __name__ == "__main__":
    main()
