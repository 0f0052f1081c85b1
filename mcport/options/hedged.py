"""Hedged portfolios on the simulated tier.

The reference applies option legs only to the *historical* return series
(app.py:657-667: legs configured → ``calc_options_series``, else pct_change);
none of its analytics can price a hedged portfolio over simulated paths. This
module composes the leg model (app.py:164-216) with the path engines — the
capability seam VERDICT r2 named highest-leverage.

Semantics
---------
A hedged asset's return over one holding interval ``prev → S`` is the
qty-weighted sum of per-leg returns, exactly :func:`legs.leg_period_return`
(app.py:164-180: intrinsic value at S minus/plus premium, normalized by
prev). Two compositions with simulated paths:

* **terminal** (the engines' default): the whole horizon is one interval —
  options expire at the horizon, settle at intrinsic value against the
  simulated terminal price ``S_T = s0·exp(term_log)``. Used by the terminal
  risk engines and frontier searches.
* **per-step**: each simulated step settles like one historical period
  (the reference's ``calc_options_series`` convention applied to a simulated
  path) — used by path-dependent (drawdown) engines in rebalance form.

Assets with no legs get the implicit BUY_ASSET qty-1 leg, so their hedged
return is exactly the plain simple return — parity with app.py:659-667.

Everything here is an elementwise transform of the (N, A) terminal
matrix the engines already produce: piecewise-linear in S, fusing into the
surrounding XLA program. Per-leg params are dense (A, L) arrays (L = max legs
per asset, qty-0 padding) so the transform is one broadcasted select chain,
no ragged structure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import jax.numpy as jnp
import numpy as np
from jax import Array

from mcport.options.legs import Legs, LegType, leg_period_return

__all__ = [
    "HedgeSpec",
    "hedged_terminal_returns",
    "hedged_from_simple",
    "hedged_step_returns",
    "hedged_return_bounds",
    "auto_hedged_sketch",
    "legs_from_spec",
]


def legs_from_spec(
    spec: Mapping[str, Mapping], names: Sequence[str], spots: Sequence[float],
) -> dict[str, Legs]:
    """Parse a JSON-style hedge config into {asset: Legs} (CLI ``--hedge``).

    Per asset, either a named reference strategy with its parameters
    (strikes/premiums default per app.py:515-581, relative to the asset's
    spot) or explicit reference-style leg rows::

        {"BTC": {"strategy": "Married Put", "params": {"premium_put": 1.5}},
         "ETH": {"legs": [["BUY_ASSET", 0, 0, 1], ["BUY_PUT", 2500, 20, 1]]}}
    """
    from mcport.options.strategies import strategy_legs

    out: dict[str, Legs] = {}
    for asset, entry in spec.items():
        if asset not in names:
            raise ValueError(
                f"hedge config asset {asset!r} is not in the universe {list(names)}")
        spot = float(spots[list(names).index(asset)])
        if "strategy" in entry:
            out[asset] = strategy_legs(
                entry["strategy"], spot, **entry.get("params", {}))
        elif "legs" in entry:
            out[asset] = Legs.from_rows([tuple(row) for row in entry["legs"]])
        else:
            raise ValueError(
                f"hedge config for {asset!r} needs 'strategy' or 'legs'")
    return out


@dataclass(frozen=True)
class HedgeSpec:
    """Dense (A, L) struct-of-arrays over the universe's option legs.

    ``qty == 0`` rows are padding. ``hedged_mask[i]`` is True iff asset i had
    explicit legs (unhedged assets carry the implicit BUY_ASSET qty-1 leg and
    a False mask). Hashable by identity only; pass the ``.arrays`` tuple into
    jitted code.
    """

    type_id: np.ndarray   # (A, L) int32
    strike: np.ndarray    # (A, L) absolute price units
    premium: np.ndarray   # (A, L) absolute price units (per app.py:164-180)
    qty: np.ndarray       # (A, L) float; 0 = padding
    hedged_mask: np.ndarray  # (A,) bool

    @property
    def n_assets(self) -> int:
        return self.type_id.shape[0]

    @property
    def arrays(self) -> tuple[Array, Array, Array, Array]:
        return (jnp.asarray(self.type_id), jnp.asarray(self.strike),
                jnp.asarray(self.premium), jnp.asarray(self.qty))

    def digest_bytes(self) -> bytes:
        """Stable bytes for checkpoint run digests."""
        return b"".join(
            np.ascontiguousarray(a, np.float64).tobytes()
            for a in (self.type_id, self.strike, self.premium, self.qty)
        )

    @classmethod
    def build(
        cls,
        legs_by_asset: Mapping[str | int, Legs | Sequence[tuple]] | None,
        names: Sequence[str],
    ) -> "HedgeSpec":
        """Build from {asset name or index: Legs | reference-style rows}.

        Unknown keys raise (a typo'd asset name silently hedging nothing is
        the failure mode we refuse). Assets absent from the mapping get the
        implicit BUY_ASSET qty-1 leg.
        """
        a = len(names)
        by_idx: dict[int, Legs] = {}
        for key, legs in (legs_by_asset or {}).items():
            if isinstance(key, str):
                if key not in names:
                    raise ValueError(
                        f"legs_by_asset key {key!r} is not in the universe "
                        f"{list(names)}")
                idx = list(names).index(key)
            else:
                idx = int(key)
                if not 0 <= idx < a:
                    raise ValueError(f"legs_by_asset index {idx} out of range (A={a})")
            if not isinstance(legs, Legs):
                legs = Legs.from_rows(list(legs))
            by_idx[idx] = legs

        max_l = max([1] + [len(v) for v in by_idx.values()])
        type_id = np.zeros((a, max_l), np.int32)
        strike = np.zeros((a, max_l))
        premium = np.zeros((a, max_l))
        qty = np.zeros((a, max_l))
        mask = np.zeros(a, bool)
        for i in range(a):
            legs = by_idx.get(i)
            if legs is None or len(legs) == 0:
                type_id[i, 0] = int(LegType.BUY_ASSET)
                qty[i, 0] = 1.0
            else:
                n = len(legs)
                type_id[i, :n] = legs.type_id
                strike[i, :n] = legs.strike
                premium[i, :n] = legs.premium
                qty[i, :n] = legs.qty
                mask[i] = True
        return cls(type_id, strike, premium, qty, mask)


def _position_return(S: Array, prev: Array, type_id: Array, strike: Array,
                     premium: Array, qty: Array) -> Array:
    """qty-weighted leg returns for a price move prev → S.

    ``S`` is (..., A); per-leg params are (A, L). The L loop is a static
    Python unroll (L ≤ a few) — each iteration is one fused (…, A) select
    chain, no (…, A, L) intermediate."""
    dt = S.dtype
    out = jnp.zeros_like(S)
    for l in range(type_id.shape[-1]):
        r = leg_period_return(
            type_id[:, l], S, prev, strike[:, l].astype(dt),
            premium[:, l].astype(dt))
        out = out + qty[:, l].astype(dt) * r
    return out


def hedged_terminal_returns(term_log: Array, s0: Array, type_id: Array,
                            strike: Array, premium: Array, qty: Array) -> Array:
    """(N, A) hedged simple returns from (N, A) terminal LOG returns.

    Terminal composition: options settle at intrinsic value against
    ``S_T = s0 · exp(term_log)``; each asset's hedged return is the
    qty-weighted leg-return sum for the move s0 → S_T (app.py:164-180 with
    the horizon as one period). Unhedged assets (implicit BUY_ASSET leg)
    reduce exactly to ``exp(term_log) - 1``.
    """
    s0 = jnp.asarray(s0, term_log.dtype)
    return _position_return(s0 * jnp.exp(term_log), s0, type_id, strike,
                            premium, qty)


def hedged_from_simple(simple: Array, s0: Array, type_id: Array, strike: Array,
                       premium: Array, qty: Array) -> Array:
    """Same terminal composition from terminal SIMPLE returns (GARCH /
    bootstrap engines, whose terminals are already simple returns)."""
    s0 = jnp.asarray(s0, simple.dtype)
    return _position_return(s0 * (1.0 + simple), s0, type_id, strike,
                            premium, qty)


def hedged_step_returns(s_prev: Array, s_cur: Array, type_id: Array,
                        strike: Array, premium: Array, qty: Array) -> Array:
    """Per-step hedged returns for a path move ``s_prev → s_cur`` (both
    (..., A) absolute prices) — the reference's per-period
    ``calc_options_series`` settlement (app.py:182-193) applied to one
    simulated step. Used by path engines in rebalance form:
    ``V_{t+1} = V_t · (1 + Σ_i w_i · r_hedged_i,t)``."""
    return _position_return(s_cur, s_prev, type_id, strike, premium, qty)


# ---- sketch bounds: exact range of a piecewise-linear payoff --------------


def hedged_return_bounds(
    spec: HedgeSpec, s_lo: np.ndarray, s_hi: np.ndarray, s0: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-asset hedged-return range for S ∈ [s_lo, s_hi].

    Each leg's return is piecewise-linear in S with a single kink at its
    strike, so the position return is PWL with kinks at the strikes: its
    extrema over an interval sit at the endpoints or interior kinks.
    Evaluating at those ≤ L+2 breakpoints gives the EXACT min/max — the
    hedged analogue of auto_sketch's Gaussian bounds, clamping-impossible by
    construction. Host-side numpy (sketch configs are static jit args).
    """
    a, L = spec.type_id.shape
    lo = np.empty(a)
    hi = np.empty(a)
    for i in range(a):
        pts = [s_lo[i], s_hi[i]]
        pts += [k for k in spec.strike[i] if s_lo[i] < k < s_hi[i]]
        S = np.asarray(pts, np.float64)
        # evaluate through the SAME leg formula the engines use (no third
        # copy of the payoff table to drift)
        r = np.zeros_like(S)
        for l in range(L):
            if spec.qty[i, l] == 0.0:
                continue
            r = r + spec.qty[i, l] * np.asarray(leg_period_return(
                jnp.asarray(int(spec.type_id[i, l])), jnp.asarray(S),
                jnp.asarray(float(s0[i])), jnp.asarray(spec.strike[i, l]),
                jnp.asarray(spec.premium[i, l])))
        lo[i], hi[i] = r.min(), r.max()
    return lo, hi


def auto_hedged_sketch(
    params, n_steps: int, spec: HedgeSpec,
    weights: np.ndarray | None = None,
    k_sigma: float = 12.0,
    n_bins: int = 8_192,
    t_dof: float | None = None,
):
    """Guaranteed-covering LINEAR-space sketch for hedged portfolio returns.

    Underlying terminal prices are bounded by the same ±k_sigma Gaussian
    log-return envelope auto_sketch uses (P[exceed] ~ 1e-33 at k=12); mapping
    that price interval through the exact PWL payoff bounds gives per-asset
    hedged-return ranges, and a long-only portfolio is a convex combination.
    Linear space because short legs can push hedged returns below -1, outside
    log1p's domain.
    """
    from mcport.config import SketchConfig

    m = np.asarray(params.mean_step, np.float64).reshape(-1)
    Lc = np.atleast_2d(np.asarray(params.chol_step, np.float64))
    s0 = np.asarray(params.s0, np.float64).reshape(-1)
    var_step = np.einsum("ij,ij->i", Lc, Lc)
    mu = n_steps * m
    sd = np.sqrt(n_steps * var_step)
    widen = 0.0
    if t_dof is not None:
        from scipy.stats import t as _t

        x = float(_t.isf(1e-13, t_dof)) / np.sqrt(t_dof / (t_dof - 2.0))
        widen = x * np.sqrt(var_step)
    s_lo = s0 * np.exp(mu - k_sigma * sd - widen)
    s_hi = s0 * np.exp(mu + k_sigma * sd + widen)
    lo_a, hi_a = hedged_return_bounds(spec, s_lo, s_hi, s0)
    if weights is None:
        lo_r, hi_r = float(lo_a.min()), float(hi_a.max())
    else:
        w = np.asarray(weights, np.float64)
        lo_r, hi_r = float(w @ lo_a), float(w @ hi_a)
    pad = max((hi_r - lo_r), 1e-6) / n_bins
    return SketchConfig(n_bins=n_bins, lo=lo_r - pad, hi=hi_r + pad,
                        space="linear")
