"""Scenario stress testing: risk deltas under shocked model parameters.

The reference reports risk only under the FITTED parameters; a production
risk process also asks "what if vol doubles / correlations converge / a
crash jump hits tonight". This module applies named parameter transforms to
a fitted :class:`GBMParams` and re-runs the same terminal-MC + sketch risk
pipeline for each, so every scenario's VaR/CVaR is computed by the identical
engine and differences are attributable to the shock alone (same seed, same
path count, same sketch construction per scenario).

Built-in shocks:

- ``vol_x{k}``      — scale the Cholesky factor by k (covariance by k^2)
- ``corr_to_one``   — blend the correlation matrix toward all-ones
  (R' = (1-lam) R + lam 11'; diversification evaporates as lam -> 1), vols
  unchanged; re-factorized with a PSD jitter guard
- ``mean_-{s}sig``  — shift each per-step mean down by s per-step sigmas
- ``crash_jump``    — overlay a systemic Merton jump (given per-step rate
  and common log-jump size) via the exact compound-Poisson terminal sampler

Custom scenarios are ``name -> (GBMParams -> GBMParams)`` transforms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from mcport.models.gbm import GBMParams

__all__ = ["StressReport", "stress_test", "path_stress_test",
           "stress_params", "scale_vol", "corr_to_one", "shift_mean"]


def scale_vol(params: GBMParams, k: float) -> GBMParams:
    """Scale volatility by k (chol by k, covariance by k^2); means unchanged."""
    return GBMParams(
        s0=params.s0, mean_step=params.mean_step,
        chol_step=np.asarray(params.chol_step) * float(k),
    )


def corr_to_one(params: GBMParams, lam: float, jitter: float = 1e-9) -> GBMParams:
    """Blend the correlation toward perfect co-movement, keeping asset vols.

    R' = (1-lam) R + lam 11' is PSD for lam in [0, 1] (convex combination of
    PSD matrices); the jitter guards the Cholesky at lam -> 1.
    """
    chol = np.asarray(params.chol_step, np.float64)
    cov = chol @ chol.T
    sd = np.sqrt(np.clip(np.diag(cov), 1e-300, None))
    corr = cov / np.outer(sd, sd)
    a = corr.shape[0]
    corr2 = (1.0 - lam) * corr + lam * np.ones((a, a))
    cov2 = np.outer(sd, sd) * corr2 + jitter * np.eye(a)
    return GBMParams(s0=params.s0, mean_step=params.mean_step,
                     chol_step=np.linalg.cholesky(cov2))


def shift_mean(params: GBMParams, n_sigmas: float) -> GBMParams:
    """Shift each per-step mean DOWN by ``n_sigmas`` per-step asset sigmas."""
    chol = np.asarray(params.chol_step, np.float64)
    sd = np.sqrt(np.einsum("ij,ij->i", chol, chol))
    return GBMParams(
        s0=params.s0,
        mean_step=np.asarray(params.mean_step, np.float64) - n_sigmas * sd,
        chol_step=params.chol_step,
    )


def _default_scenarios() -> dict[str, Callable[[GBMParams], GBMParams]]:
    return {
        "vol_x1.5": lambda p: scale_vol(p, 1.5),
        "vol_x2": lambda p: scale_vol(p, 2.0),
        "corr_to_one": lambda p: corr_to_one(p, 0.9),
        "mean_-1sig": lambda p: shift_mean(p, 1.0),
    }


@dataclass(frozen=True)
class StressReport:
    base: dict[str, float]                     # var/cvar/port_mean at the fit
    scenarios: dict[str, dict[str, float]]    # per scenario: metrics + deltas

    def worst(self, metric: str = "cvar") -> tuple[str, dict[str, float]]:
        """(name, metrics) of the scenario with the worst (lowest) metric."""
        name = min(self.scenarios, key=lambda k: self.scenarios[k][metric])
        return name, self.scenarios[name]


def _risk_of(params: GBMParams, weights: np.ndarray, n_paths: int,
             n_steps: int, alpha: float, seed: int) -> dict[str, float]:
    import jax
    import jax.numpy as jnp

    from mcport.models.gbm import terminal_log_returns
    from mcport.ops.quantile import auto_sketch, histogram, sketch_var_cvar

    sketch = auto_sketch(params.mean_step, params.chol_step, n_steps)
    term = terminal_log_returns(
        jax.random.key(seed), jnp.asarray(params.mean_step, jnp.float32),
        jnp.asarray(params.chol_step, jnp.float32), n_paths, n_steps,
    )
    port = (jnp.exp(term) - 1.0) @ jnp.asarray(weights, jnp.float32)
    v, c = sketch_var_cvar(histogram(port, sketch), alpha, sketch)
    return {"var": float(v), "cvar": float(c), "port_mean": float(port.mean())}


def stress_params(params: GBMParams, name: str) -> GBMParams:
    """Apply one built-in scenario by name (exposed for composition)."""
    scen = _default_scenarios()
    if name not in scen:
        raise ValueError(f"unknown scenario {name!r}; built-ins: {sorted(scen)}")
    return scen[name](params)


_DEFAULT_CRASH: tuple[float, float] = (0.05, -0.10)


def stress_test(
    params: GBMParams,
    weights: np.ndarray,
    scenarios: Mapping[str, Callable[[GBMParams], GBMParams]] | None = None,
    n_paths: int = 262_144,
    n_steps: int = 52,
    alpha: float = 0.95,
    seed: int = 0,
    crash_jump: tuple[float, float] | None = _DEFAULT_CRASH,
) -> StressReport:
    """Run the identical risk pipeline under each shocked parameter set.

    ``crash_jump=(rate_per_step, common_log_jump_mean)`` adds a systemic
    Merton overlay scenario via the exact compound-Poisson sampler (jump vol
    = |mean|/2); pass None to skip it. Every scenario reports var/cvar/mean
    plus deltas vs the base fit — same seed and path count throughout, so
    deltas isolate the shock.
    """
    w = np.asarray(weights, np.float64)
    # identity vs the sentinel, not value equality: an explicitly passed
    # (0.05, -0.10) is still an explicit ask for the crash overlay
    _crash_explicit = crash_jump is not _DEFAULT_CRASH
    base = _risk_of(params, w, n_paths, n_steps, alpha, seed)
    scen = dict(_default_scenarios() if scenarios is None else scenarios)

    out: dict[str, dict[str, float]] = {}
    for name, transform in scen.items():
        m = _risk_of(transform(params), w, n_paths, n_steps, alpha, seed)
        m["d_var"] = m["var"] - base["var"]
        m["d_cvar"] = m["cvar"] - base["cvar"]
        out[name] = m

    if crash_jump is not None and (scenarios is None or _crash_explicit):
        import jax

        from mcport.models.jump import MertonParams, merton_risk

        rate, mu_j = crash_jump
        a = params.n_assets
        mp = MertonParams(
            diffusion=params, jump_rate=float(rate),
            jump_mean=np.full(a, float(mu_j)),
            jump_vol=np.full(a, abs(float(mu_j)) / 2.0),
        )
        jr = merton_risk(jax.random.key(seed), mp, w, n_paths=n_paths,
                         n_steps=n_steps, alpha=alpha)
        out["crash_jump"] = {
            "var": float(jr.var), "cvar": float(jr.cvar),
            "port_mean": float(jr.port_mean),
            "d_var": float(jr.var) - base["var"],
            "d_cvar": float(jr.cvar) - base["cvar"],
        }

    return StressReport(base=base, scenarios=out)


def path_stress_test(
    params: GBMParams,
    weights: np.ndarray,
    scenarios: Mapping[str, Callable[[GBMParams], GBMParams]] | None = None,
    n_paths: int = 65_536,
    n_steps: int = 52,
    path_block: int = 8_192,
    alpha: float = 0.95,
    seed: int = 0,
    crash_jump: tuple[float, float] | None = _DEFAULT_CRASH,
    rebalance: bool = True,
) -> StressReport:
    """Scenario stress on the PATH tier: max-drawdown distribution deltas.

    Same shocked-parameter transforms as :func:`stress_test`, but every
    scenario re-runs the path-risk engine (terminal VaR/CVaR plus the
    simulated max-drawdown distribution — :mod:`mcport.engine.path_risk`,
    fused kernels on the GPU) with the same seed/grid, so
    ``d_dd_p95``/``d_dd_median`` deltas isolate the shock's effect on the
    drawdown profile — the question terminal stress can't answer: "how much
    deeper do in-horizon drawdowns get if vol doubles / correlations
    converge / crashes arrive?" The crash overlay runs through the
    common-jump Merton PATH engine (per-step Bernoulli jump clock), which is
    inherently per-period REBALANCED — with ``rebalance=False`` its deltas
    mix wealth conventions, so the scenario dict carries an explicit
    ``settlement`` note in that case. ``n_paths`` rounds up to whole path
    blocks (the CLI convention).
    """
    from mcport.config import GBMConfig
    from mcport.engine.path_risk import run_merton_path_risk, run_path_risk

    w = np.asarray(weights, np.float64)
    _crash_explicit = crash_jump is not _DEFAULT_CRASH
    block = min(path_block, n_paths)
    n_paths = -(-n_paths // block) * block    # whole blocks (CLI convention)
    cfg = GBMConfig(n_paths=n_paths, path_block=block,
                    n_steps=n_steps, seed=seed)

    def metrics(rep):
        return {"var": rep.var, "cvar": rep.cvar, "port_mean": rep.port_mean,
                "dd_mean": rep.dd_mean, "dd_median": rep.dd_median,
                "dd_p95": rep.dd_p95}

    base = metrics(run_path_risk(params, w, cfg, alpha=alpha,
                                 rebalance=rebalance))
    scen = dict(_default_scenarios() if scenarios is None else scenarios)

    def deltas(m):
        m["d_cvar"] = m["cvar"] - base["cvar"]
        m["d_dd_p95"] = m["dd_p95"] - base["dd_p95"]
        m["d_dd_median"] = m["dd_median"] - base["dd_median"]
        return m

    out: dict[str, dict[str, float]] = {}
    for name, transform in scen.items():
        out[name] = deltas(metrics(run_path_risk(
            transform(params), w, cfg, alpha=alpha, rebalance=rebalance)))

    if crash_jump is not None and (scenarios is None or _crash_explicit):
        from mcport.models.jump import MertonParams

        rate, mu_j = crash_jump
        a = params.n_assets
        mp = MertonParams(
            diffusion=params, jump_rate=float(rate),
            jump_mean=np.full(a, float(mu_j)),
            jump_vol=np.full(a, abs(float(mu_j)) / 2.0),
        )
        out["crash_jump"] = deltas(metrics(run_merton_path_risk(
            mp, w, cfg, alpha=alpha)))
        if not rebalance:
            out["crash_jump"]["settlement"] = (
                "rebalanced (Merton path engine); base is buy-and-hold — "
                "deltas mix wealth conventions")

    return StressReport(base=base, scenarios=out)
