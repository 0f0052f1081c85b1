"""Configuration tree for mcport.

The reference (``/root/reference/app.py``) has no config system — every knob is an
interactive Streamlit widget or a hardcoded constant (survey: SURVEY.md §5 "Config /
flag system"). This module freezes that implicit parameter surface into dataclasses
whose defaults equal the reference's values:

- analysis period selectbox → resample rule + annualization factor (app.py:425-427)
- risk-free rate, default 3%/yr (app.py:428) — **divergence**: the reference treats the
  percent entry 3.0 as a decimal return (a 300%/yr rate, see SURVEY.md §2 "Risk-free
  units bug"); mcport takes rf as a decimal (0.03) and documents the fix.
- total investment, default 10_000 USD (app.py:431-435)
- per-asset weight bounds, defaults 0/1 (app.py:449-456)
- n_portfolios = 2500 (app.py:681), rejection retries = 100 (app.py:701)
- VaR/CVaR confidence alpha = 0.95 (app.py:685)
- forecast horizons [1, 3, 6] (app.py:789)
- payoff grid: 100 points over 0.5x-1.5x spot (app.py:593)

On top of the reference surface it adds the Monte Carlo engine knobs required by
BASELINE.json (GBM paths/steps, variance reduction, sharding, quantile sketch).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any


# Analysis period: reference labels are Persian (app.py:425); we key by the pandas
# resample rule. pandas>=3 renamed 'M'->'ME' and 'Q'->'QE'; we accept both spellings.
_PERIOD_TABLE = {
    "M": ("ME", 12),   # ماهانه (monthly)
    "ME": ("ME", 12),
    "Q": ("QE", 4),    # سه‌ماهه (quarterly)
    "QE": ("QE", 4),
    "W": ("W", 52),    # هفتگی (weekly)
    "D": ("D", 252),   # daily (calc_asset_stats supports it, app.py:290-292)
}


def period_info(period: str) -> tuple[str, int]:
    """Map a period code to (pandas resample rule, annualization factor).

    Mirrors the selectbox mapping at app.py:426-427 plus the 'D' branch of
    calc_asset_stats (app.py:290-292).
    """
    try:
        return _PERIOD_TABLE[period.upper()]
    except KeyError:
        raise ValueError(
            f"unknown period {period!r}; expected one of {sorted(_PERIOD_TABLE)}"
        ) from None


@dataclass(frozen=True)
class DataConfig:
    """Data ingestion + returns pipeline (app.py:89-162, 469-482)."""

    period: str = "M"                  # resample period code (M/Q/W/D)
    strip_thousands: bool = True       # fix for the reference's comma-price data loss
    price_priority: tuple[str, ...] = ("price", "close", "adj close", "open")
    header_scan_rows: int = 5          # header-sniff window (app.py:100)

    @property
    def resample_rule(self) -> str:
        return period_info(self.period)[0]

    @property
    def annual_factor(self) -> int:
        return period_info(self.period)[1]


@dataclass(frozen=True)
class PortfolioConfig:
    """Global portfolio settings (app.py:424-458)."""

    risk_free: float = 0.03            # decimal per year (reference default 3.0 percent)
    investment_amount: float = 10_000.0
    min_weights: tuple[float, ...] | None = None   # per-asset; None → all 0.0
    max_weights: tuple[float, ...] | None = None   # per-asset; None → all 1.0


@dataclass(frozen=True)
class SimulationConfig:
    """Random-weight portfolio search (app.py:669-723)."""

    n_portfolios: int = 2_500          # app.py:681
    max_retries: int = 100             # rejection-sampling rounds (app.py:701)
    alpha: float = 0.95                # VaR/CVaR confidence (app.py:685)
    seed: int = 0
    target_risk: float = 0.30          # target-risk objective (README.md:4 north star)
    dtype: str = "float32"


@dataclass(frozen=True)
class GBMConfig:
    """Correlated-GBM path engine (new scope; BASELINE.json:5,8,10,11)."""

    n_paths: int = 131_072             # divisible by the default path_block
    n_steps: int = 252
    dt: float = 1.0 / 252.0
    seed: int = 0
    antithetic: bool = False
    qmc: str = "none"                  # none | sobol | halton
    dtype: str = "float32"
    path_block: int = 8_192            # paths per device-side block (chunked scan)
    use_pallas: bool | None = None     # fused kernel: None = on the GPU only
                                       # (mcport.ops.dispatch), False = lax,
                                       # True = demand it (error off the GPU)
    auto_sketch: bool = True           # derive the quantile-sketch range from the
                                       # fitted params (log1p space); False = use
                                       # Config.sketch verbatim
    innovations: str = "normal"        # "normal" | "student_t" (fat tails; the
                                       # fused kernel draws polar t)
    t_dof: float = 6.0                 # Student-t degrees of freedom (see
                                       # models.gbm.estimate_t_dof)
    ci_boot: int = 0                   # >0: bootstrap-the-sketch error bars on
                                       # the reported VaR/CVaR (and drawdown
                                       # quantiles where present) with this
                                       # many multinomial replicates; pure
                                       # post-processing — never touches the
                                       # draw streams or checkpoint digests
    bm: str = "poly"                   # kernel normal tier: "poly" (exact-f32
                                       # default) | "poly_fast" (degree-5
                                       # screening fits, draw error <= ~1.5e-4
                                       # — kernel path only; the lax form
                                       # always draws exact normals)


@dataclass(frozen=True)
class SketchConfig:
    """On-device quantile sketch for huge path counts (BASELINE.json:10).

    ``space`` selects the binning coordinate: "linear" bins returns directly over
    [lo, hi]; "log1p" bins u = log1p(r) with lo/hi given in u-space — the adaptive
    form that covers any return scale with relative resolution (simple returns
    live in (-1, inf)). Use :func:`mcport.ops.quantile.auto_sketch` to derive a
    guaranteed-covering log1p config from GBM parameters.
    """

    n_bins: int = 8_192
    lo: float = -1.0                   # bin range, in `space` coordinates
    hi: float = 3.0
    space: str = "linear"              # "linear" | "log1p"


# A generous covering log1p-space sketch for engines without an analytic range
# (GARCH terminals, user-supplied streams): -99.99%..+100000% simple return at
# relative resolution. One shared definition — CLI and API must not diverge.
COVERING_LOG1P_SKETCH = SketchConfig(
    n_bins=8_192,
    lo=math.log1p(-0.9999),
    hi=math.log1p(1000.0),
    space="log1p",
)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding layout (BASELINE.json:5)."""

    paths_axis: str = "paths"
    cand_axis: str = "cand"


@dataclass(frozen=True)
class ForecastConfig:
    """ARIMA(1,1,1)+GARCH(1,1) forecaster (app.py:337-364)."""

    horizons: tuple[int, ...] = (1, 3, 6)
    ci_z: float = 1.96                 # 95% CI multiplier (app.py:355-356)
    fallback_band: float = 0.10        # bare-except fallback ±10% (app.py:363)


@dataclass(frozen=True)
class PayoffConfig:
    """Payoff-curve grid (app.py:593)."""

    n_points: int = 100
    lo_mult: float = 0.5
    hi_mult: float = 1.5


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    portfolio: PortfolioConfig = field(default_factory=PortfolioConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    gbm: GBMConfig = field(default_factory=GBMConfig)
    sketch: SketchConfig = field(default_factory=SketchConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    forecast: ForecastConfig = field(default_factory=ForecastConfig)
    payoff: PayoffConfig = field(default_factory=PayoffConfig)

    # ---- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp: type, sub: dict[str, Any]) -> Any:
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kw = {}
            for k, v in sub.items():
                if k not in fields:
                    raise ValueError(f"unknown config key {tp.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kw[k] = v
            return tp(**kw)

        kw: dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                sub = d[f.name]
                tp = f.default_factory  # type: ignore[misc]
                kw[f.name] = build(tp, sub) if isinstance(sub, dict) else sub
        return cls(**kw)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))
