"""BASELINE.json configs 1 & 3: random-weight search throughput.

- config 1: 2-asset BTC/ETH weekly, 10k candidates, Sharpe-max;
- config 3: 15-asset universe, 1M candidates, target-risk 30% constrained pick;
- measured CPU baseline: the serial NumPy restatement of the reference loop.

Emits JSONL records via RunLogger. Run: python benchmarks/bench_weight_search.py
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.reference_numpy import reference_weight_search
from mcport.config import DataConfig
from mcport.data import load_universe
from mcport.engine import run_method
from mcport.utils.logging import RunLogger

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"


def main() -> None:
    log = RunLogger(stream=sys.stdout)
    backend = jax.default_backend()

    # ---- config 1: 2-asset, 10k candidates --------------------------------
    d2 = load_universe(
        paths=[FIXTURES / "BTC_USD 7 Years Weekly.csv", FIXTURES / "ETH_USD 7 Years Weekly.csv"],
        config=DataConfig(period="W"),
    )
    n1 = 10_000
    t0 = time.perf_counter()
    r = run_method(jax.random.key(0), "Monte Carlo", d2.port_rets, d2.mean_ann,
                   d2.cov_ann, risk_free=0.03, n_portfolios=n1)
    t_jax = time.perf_counter() - t0  # includes compile; steady-state below
    t0 = time.perf_counter()
    r = run_method(jax.random.key(1), "Monte Carlo", d2.port_rets, d2.mean_ann,
                   d2.cov_ann, risk_free=0.03, n_portfolios=n1)
    t_jax_steady = time.perf_counter() - t0
    log.log("config1_jax", backend=backend, n=n1, seconds=t_jax_steady,
            candidates_per_sec=n1 / t_jax_steady, sharpe_star=float(r.metric[r.opt_idx]))

    n_ref = 2_500  # the reference's own workload size (app.py:681)
    t0 = time.perf_counter()
    _, _, metrics, _ = reference_weight_search(
        d2.port_rets, d2.mean_ann, d2.cov_ann, n_ref, 0.03,
        np.zeros(2), np.ones(2), seed=0)
    t_ref = time.perf_counter() - t0
    log.log("config1_numpy_reference", n=n_ref, seconds=t_ref,
            candidates_per_sec=n_ref / t_ref, sharpe_star=float(np.max(metrics)))
    log.log("config1_speedup", jax_vs_numpy_per_candidate=(n_ref / t_ref) and
            (n1 / t_jax_steady) / (n_ref / t_ref))

    # ---- config 3: full universe, 1M candidates, target-risk --------------
    daily = sorted(p for p in FIXTURES.glob("*.csv") if "7 Years Weekly" not in p.name)
    d15 = load_universe(paths=daily, config=DataConfig(period="D"))
    n3 = 1_000_000 if backend == "gpu" else 100_000
    t0 = time.perf_counter()
    r3 = run_method(jax.random.key(0), "Target Risk", d15.port_rets, d15.mean_ann,
                    d15.cov_ann, risk_free=0.03, n_portfolios=n3, target_risk=0.30)
    t3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r3 = run_method(jax.random.key(1), "Target Risk", d15.port_rets, d15.mean_ann,
                    d15.cov_ann, risk_free=0.03, n_portfolios=n3, target_risk=0.30)
    t3s = time.perf_counter() - t0
    log.log("config3_target_risk", backend=backend, n_assets=d15.n_assets, n=n3,
            seconds=t3s, candidates_per_sec=n3 / t3s,
            opt_std=float(r3.std[r3.opt_idx]), opt_ret=float(r3.ret[r3.opt_idx]))


if __name__ == "__main__":
    main()
