"""Benchmark fleet on one GPU: one JSON line per kernel/config, headline LAST.

The headline line is printed last:
    {"metric": "gbm_path_steps_per_sec_per_chip", ...}

Before it the fleet emits one line each for the other hot kernels and the two
wall-clock configs:

    gbm_terminal_hedged_*   terminal engine + option-leg settlement
    gbm_terminal_fast_*     the poly_fast screening tier
    gbm_path_stats_*        fused per-step portfolio/drawdown kernel
    multi_dd_{f32,tf32,bf16}_* candidate-scoring drawdown kernel tiers
    dd_frontier_auto_*      bf16 screen + exact rescore vs full f32
    greeks_*                pathwise Greeks (jacrev through the simulation)
    config3_*               1M-candidate CONSTRAINED streaming frontier
                            (cold = incl. compile, warm) [BASELINE config 3]
    config4_*               16.7M-path sketch tail risk wall [BASELINE config 4]

Every line names the device as JAX reports it and the card's name and power
limit as nvidia-smi reports them. The bench needs a GPU: without one it
prints an error line and exits non-zero; it never falls back to the CPU.

Timing: every throughput uses the same-process K-vs-2K difference protocol
with data-chained reps and a scalar VALUE fetch (utils.profiling.diff_timed).
path-steps/s lines quote vs_baseline against BASELINE.json's 1e9/chip target;
lines without a driver target carry vs_baseline null. Each fleet entry is
fail-isolated: an error prints an "error" line and the headline still runs.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

BASELINE_PATH_STEPS_PER_SEC = 1e9  # BASELINE.json:5 target
N_ASSETS = 15
N_STEPS = 252
N_PATHS = 1_048_576

# Timing window (VERDICT r4 weak #2): k reps per difference window, best of
# TRIALS trials — the repo's documented protocol for trustworthy deltas.
K = 16
TRIALS = 3

_DEVICE: dict = {}


def _card() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _emit(metric, value, unit, vs_baseline=None):
    print(json.dumps({
        "metric": metric, "value": round(value, 4), "unit": unit,
        "vs_baseline": None if vs_baseline is None else round(vs_baseline, 4),
        **_DEVICE,
    }), flush=True)


def _universe():
    rng = np.random.default_rng(0)
    corr = 0.5 * np.eye(N_ASSETS) + 0.5
    chol = np.linalg.cholesky(0.0004 * corr).astype(np.float32)
    mean = rng.normal(1e-3, 5e-4, N_ASSETS).astype(np.float32)
    return mean, chol


def _chain(one):
    """Lazy-import alias of :func:`mcport.utils.profiling.seed_chain`
    (bench.py imports jax and mcport only inside its stages)."""
    from mcport.utils.profiling import seed_chain

    return seed_chain(one)


def fleet(mean, chol):
    import jax
    import jax.numpy as jnp

    from mcport.utils.profiling import diff_timed

    rng = np.random.default_rng(1)

    # -- hedged terminal: the engine composition measure (VERDICT r2 item 1).
    # Married puts on 5 assets + covered calls on 3 over s0=100 — settle vs
    # simulated terminal prices, then the weight dot. Overhead is reported
    # as hedged-vs-plain ratio of the SAME (terminal + portfolio dot) chain.
    from mcport.ops.pallas_gbm import pallas_terminal_log_returns
    from mcport.options import HedgeSpec, LegType, Legs
    from mcport.options.hedged import hedged_terminal_returns

    names = [f"a{i}" for i in range(N_ASSETS)]
    legs = {}
    for i in range(5):
        legs[names[i]] = Legs.from_rows([
            (LegType.BUY_ASSET, 0.0, 0.0, 1.0),
            (LegType.BUY_PUT, 90.0, 1.5, 1.0)])
    for i in range(5, 8):
        legs[names[i]] = Legs.from_rows([(LegType.SELL_CALL, 110.0, 2.0, 1.0)])
    spec = HedgeSpec.build(legs, names)
    s0 = jnp.full((N_ASSETS,), 100.0, jnp.float32)
    w = jnp.asarray(rng.dirichlet(np.ones(N_ASSETS)), jnp.float32)
    harr = spec.arrays

    @jax.jit
    def plain(seed):
        term = pallas_terminal_log_returns(seed, mean, chol, N_PATHS, N_STEPS)
        return ((jnp.exp(term) - 1.0) @ w).sum() * 1e-9

    @jax.jit
    def hedged(seed):
        term = pallas_terminal_log_returns(seed, mean, chol, N_PATHS, N_STEPS)
        return (hedged_terminal_returns(term, s0, *harr) @ w).sum() * 1e-9

    t_plain = diff_timed(_chain(plain), k=K, trials=TRIALS)
    t_hedged = diff_timed(_chain(hedged), k=K, trials=TRIALS)
    rate_h = N_PATHS * N_STEPS / t_hedged
    _emit("gbm_terminal_hedged_path_steps_per_sec", rate_h,
          "path-steps/s (15 assets, 8 hedged, 252 steps, f32)",
          rate_h / BASELINE_PATH_STEPS_PER_SEC)
    _emit("hedged_overhead_vs_terminal_pct", (t_hedged / t_plain - 1.0) * 100,
          "% wall overhead of option settlement on the terminal engine")

    # -- screening-tier terminal (bm="poly_fast", round 4): degree-5 normal
    # fits, draw error <=1.5e-4 worst-case — the frontier/VaR screening tier
    @jax.jit
    def plain_fast(seed):
        term = pallas_terminal_log_returns(seed, mean, chol, N_PATHS, N_STEPS,
                                           bm="poly_fast")
        return ((jnp.exp(term) - 1.0) @ w).sum() * 1e-9

    rate_f = N_PATHS * N_STEPS / diff_timed(_chain(plain_fast), k=K, trials=TRIALS)
    _emit("gbm_terminal_fast_path_steps_per_sec", rate_f,
          "path-steps/s (15 assets, 252 steps, poly_fast screening tier)",
          rate_f / BASELINE_PATH_STEPS_PER_SEC)

    # -- path-stats kernel (terminal + per-step portfolio value + drawdown)
    from mcport.ops.pallas_gbm import gbm_path_stats

    @jax.jit
    def pstats(seed):
        term, port, dd = gbm_path_stats(seed, mean, chol, w, N_PATHS, N_STEPS)
        return (port.sum() + dd.sum()) * 1e-9

    rate = N_PATHS * N_STEPS / diff_timed(_chain(pstats), k=K, trials=TRIALS)
    _emit("gbm_path_stats_path_steps_per_sec", rate,
          "path-steps/s (15 assets, 252 steps)",
          rate / BASELINE_PATH_STEPS_PER_SEC)

    # -- multi-portfolio drawdown scoring tiers
    from mcport.ops.pallas_multi_dd import gbm_multi_portfolio_dd

    n_cand, dd_paths = 256, 131_072
    cand = rng.dirichlet(np.ones(N_ASSETS), size=n_cand).astype(np.float32)
    for sd, label in (("float32", "f32"), ("tensorfloat32", "tf32"),
                      ("bfloat16", "bf16")):
        @jax.jit
        def mdd(seed, sd=sd):
            term, dd = gbm_multi_portfolio_dd(
                seed, mean, chol, cand, dd_paths, N_STEPS, score_dtype=sd)
            return (term.sum() + dd.sum()) * 1e-9

        rate = n_cand * dd_paths * N_STEPS / diff_timed(_chain(mdd), k=K, trials=TRIALS)
        _emit(f"multi_dd_{label}_cand_path_steps_per_sec", rate,
              f"cand-path-steps/s (256 cand, 131072 paths, 252 steps, {sd})")

    # -- drawdown-frontier auto precision tier (round 4): the engine default
    # resolves score_dtype="auto" to the bf16 screen + exact winner rescore
    # on big buy-and-hold workloads; identical optimum, less wall
    from mcport.engine.drawdown_frontier import drawdown_frontier_search
    from mcport.models.gbm import GBMParams

    fp = GBMParams(s0=np.full(N_ASSETS, 100.0), mean_step=np.asarray(mean),
                   chol_step=np.asarray(chol))
    # 1.4e11 cand-path-steps: the screen dominates the rescore dispatch
    fkw = dict(dd_budget=0.5, n_candidates=4096, n_paths=131_072,
               n_steps=N_STEPS, w_block=256)

    def frontier_wall(sd):
        t0 = time.perf_counter()
        r = drawdown_frontier_search(jax.random.key(5), fp, score_dtype=sd,
                                     **fkw)
        return time.perf_counter() - t0, r

    frontier_wall("float32")                    # compile both programs
    frontier_wall("auto")
    t32, r32 = frontier_wall("float32")         # warm walls
    tauto, rauto = frontier_wall("auto")
    # equivalent = same candidate, or distinct candidates whose exact mean
    # returns tie within the cross-program reduction ulp (both exact-optimal);
    # opt_idx < 0 means "no feasible candidate" — never index with it (ret[-1]
    # would silently compare an arbitrary candidate)
    feasible = int(r32.opt_idx) >= 0 and int(rauto.opt_idx) >= 0
    same = feasible and (
        r32.opt_idx == rauto.opt_idx
        or abs(float(r32.ret[r32.opt_idx]) - float(rauto.ret[rauto.opt_idx]))
        <= 4e-7 * max(1.0, abs(float(r32.ret[r32.opt_idx]))))
    _emit("dd_frontier_auto_speedup", t32 / max(tauto, 1e-9),
          f"x wall vs full-f32 (4096 cand, 131072 paths, 252 steps, warm; "
          f"optimum equivalent: {bool(same)})")

    # -- pathwise Greeks (round 4): warm wall of the full jacrev — 1 forward
    # + 3 reverse passes of the remat'd 131072x252 simulation per call
    import time as _time

    from mcport.config import GBMConfig
    from mcport.engine.greeks import portfolio_sensitivities
    from mcport.models.gbm import GBMParams

    gp = GBMParams(mean_step=np.asarray(mean), chol_step=np.asarray(chol),
                   s0=np.full(N_ASSETS, 100.0))
    gw = np.full(N_ASSETS, 1.0 / N_ASSETS)
    gcfg = GBMConfig(n_paths=131_072, n_steps=N_STEPS, seed=0)
    portfolio_sensitivities(gp, gw, gcfg)            # compile
    t0 = _time.perf_counter()
    gout = portfolio_sensitivities(gp, gw, gcfg)     # host API incl. fetch
    gwall = _time.perf_counter() - t0
    _emit("greeks_jacrev_warm_wall_s", gwall,
          f"s (mean/VaR/CVaR grads wrt w+mu+vol, 131072x252 remat'd sim; "
          f"euler_gap_cvar {gout.euler_gap_cvar:.1e})")


def configs(mean, chol):
    """BASELINE configs 3 and 4: end-to-end wall times (cold incl. compile)."""
    import jax

    from mcport.engine.simulated_frontier import simulated_weight_search_streaming
    from mcport.models.gbm import GBMParams

    params = GBMParams(s0=np.full(N_ASSETS, 100.0),
                       mean_step=np.asarray(mean, np.float64),
                       chol_step=np.asarray(chol, np.float64))
    min_w = np.full(N_ASSETS, 0.01)
    max_w = np.full(N_ASSETS, 0.60)

    def run_c3():
        t0 = time.perf_counter()
        simulated_weight_search_streaming(
            jax.random.key(0), params, n_candidates=1_048_576, n_paths=16_384,
            n_steps=N_STEPS, objective="cvar", min_weights=min_w,
            max_weights=max_w)
        return time.perf_counter() - t0

    cold = run_c3()
    warm = min(run_c3(), run_c3())
    _emit("config3_streaming_1m_constrained_cold_s", cold,
          "s wall, 1M constrained candidates incl. compile (config 3)")
    _emit("config3_streaming_1m_constrained_warm_s", warm,
          "s wall, warm (config 3)")

    from mcport.config import GBMConfig
    from mcport.engine.mc_engine import run_resumable_mc

    cfg = GBMConfig(n_paths=16_777_216, path_block=1_048_576, n_steps=N_STEPS)
    w = np.full(N_ASSETS, 1.0 / N_ASSETS)
    t0 = time.perf_counter()
    report, _ = run_resumable_mc(params, w, cfg)
    wall = time.perf_counter() - t0
    _emit("config4_16m_tail_wall_s", wall,
          f"s wall, 16.7M-path VaR/CVaR sketch (config 4; cvar={report.cvar:.4f})")


def headline(mean, chol):
    import jax
    import jax.numpy as jnp

    from mcport.ops.pallas_gbm import pallas_terminal_log_returns

    n_paths = N_PATHS

    def one(seed):
        return pallas_terminal_log_returns(seed, mean, chol, n_paths, N_STEPS).sum()

    # K-vs-2K difference with data-chained on-device fori_loop reps and a
    # scalar VALUE fetch (see module docstring for why).
    REPS = 5

    def make_loop(k):
        @jax.jit
        def loop(seed0):
            def body(i, acc):
                chain = jnp.int32(acc * 1e-6) & 7
                return acc + one(seed0 + (i + 1) * (1 << 20) + chain)
            return jax.lax.fori_loop(0, k, body, jnp.float32(0))
        return loop

    float(jnp.zeros(()).sum())                 # warm the transfer path first
    loop_k, loop_2k = make_loop(REPS), make_loop(2 * REPS)
    float(loop_k(jnp.asarray(0, jnp.int32)))   # compile
    float(loop_2k(jnp.asarray(0, jnp.int32)))

    def timed(fn, seed):
        t0 = time.perf_counter()
        float(fn(jnp.asarray(seed, jnp.int32)))  # value fetch = true completion
        return time.perf_counter() - t0

    t_k = min(timed(loop_k, 11), timed(loop_k, 13))
    t_2k = min(timed(loop_2k, 17), timed(loop_2k, 19))
    dt = max(t_2k - t_k, 1e-9) / REPS
    value = n_paths * N_STEPS / dt

    _emit("gbm_path_steps_per_sec_per_chip", value,
          "path-steps/s (15 assets, 252 steps, f32)",
          value / BASELINE_PATH_STEPS_PER_SEC)


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({"metric": "gbm_path_steps_per_sec_per_chip",
                          "error": f"no GPU (JAX platform {dev.platform!r})"}))
        return 1
    _DEVICE.update(device={"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())}, card=_card())
    mean, chol = _universe()
    for stage in (fleet, configs):
        try:
            stage(mean, chol)
        except Exception as e:  # fail-isolated: the headline must still print
            _emit(f"{stage.__name__}_error", 0.0, f"{type(e).__name__}: {e}")
    headline(mean, chol)
    return 0


if __name__ == "__main__":
    sys.exit(main())
