"""Prices → returns → device-array pipeline, in NumPy.

Replicates the reference's data assembly exactly:

- name disambiguation via a Counter suffix "name (2)" (app.py:442-447, 466-472)
- per-asset series inner-joined on Date (app.py:473-479)
- ``resample(rule).last().dropna()`` (app.py:482) for the rules D (calendar
  day), W (weeks ending Sunday), ME (month end) and QE (quarter end): the
  last joined row of each period, empty periods dropped
- two return conventions, both used by the reference:
    * stats returns:     ``pct_change().dropna()``   (app.py:288-298, tab 0)
    * portfolio returns: ``pct_change().fillna(0)``  (app.py:666, tab 2 — keeps a
      leading all-zero row, which feeds the moment estimates; parity requires it)
- annualized moments ``mean()*ann`` / ``cov()*ann`` (app.py:679-680; ddof=1)

Everything downstream of :func:`load_universe` is pure JAX.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from mcport.config import DataConfig, period_info
from mcport.data.csv_loader import PriceSeries, read_csv_file

__all__ = [
    "dedupe_names",
    "combine_prices",
    "period_labels",
    "stats_returns",
    "portfolio_returns",
    "annualized_moments",
    "load_universe",
    "PriceData",
]


def dedupe_names(names: Iterable[str]) -> list[str]:
    """Disambiguate duplicate asset names with a " (k)" suffix (app.py:442-447)."""
    counter: Counter[str] = Counter()
    out = []
    for base in names:
        counter[base] += 1
        out.append(base if counter[base] == 1 else f"{base} ({counter[base]})")
    return out


def period_labels(dates: np.ndarray, rule: str) -> np.ndarray:
    """The period-end label (datetime64[D]) of each date under a resample rule."""
    days = dates.astype("datetime64[D]")
    if rule == "D":
        return days
    if rule == "W":
        # 1970-01-01 was a Thursday: weekday (Mon=0) = (days + 3) % 7
        weekday = (days.astype(np.int64) + 3) % 7
        return days + (6 - weekday).astype("timedelta64[D]")
    months = days.astype("datetime64[M]")
    if rule == "ME":
        return (months + 1).astype("datetime64[D]") - 1
    if rule == "QE":
        m = months.astype(np.int64)            # months since 1970-01
        q_end = m - m % 3 + 3                  # first month after the quarter
        return q_end.astype("datetime64[M]").astype("datetime64[D]") - 1
    raise ValueError(f"unsupported resample rule {rule!r}; expected D/W/ME/QE")


def combine_prices(
    named_series: Sequence[tuple[str, PriceSeries]], resample_rule: str = "ME"
) -> tuple[np.ndarray, np.ndarray]:
    """Inner-join per-asset series on date and resample to period end.

    Parity with app.py:466-482: inner join on Date, sort by date, then
    ``resample(rule).last().dropna()``. Returns ``(period labels (T,)
    datetime64[D], prices (T, A))``.
    """
    common = None
    for _, s in named_series:
        d = np.unique(s.dates)
        common = d if common is None else np.intersect1d(common, d,
                                                         assume_unique=True)
    cols = []
    for _, s in named_series:
        # the last row for a date in file order (join keys are unique dates)
        order = np.argsort(s.dates, kind="stable")
        d, p = s.dates[order], s.prices[order]
        last = np.searchsorted(d, common, side="right") - 1
        cols.append(p[last])
    prices = np.stack(cols, axis=1) if cols else np.empty((0, 0))
    labels = period_labels(common, resample_rule)
    # last joined row of each period (dates ascend, so periods ascend too)
    ends = np.flatnonzero(np.r_[labels[1:] != labels[:-1], True]) if len(labels) else []
    out_labels, out = labels[ends], prices[ends]
    if out.shape[0] == 0:
        # The reference would silently carry an empty frame into the stats/sim
        # tabs and crash later; fail at the boundary instead (mixing calendars,
        # e.g. weekly-dated with daily-dated files, is the usual cause).
        raise ValueError(
            "inner join of asset histories is empty after resampling - "
            "the assets share no common dates (check mixed daily/weekly files)"
        )
    return out_labels, out


def stats_returns(prices: np.ndarray) -> np.ndarray:
    """Tab-0 convention: ``pct_change().dropna()`` (app.py:288-298)."""
    return prices[1:] / prices[:-1] - 1.0


def portfolio_returns(prices: np.ndarray) -> np.ndarray:
    """Tab-2 convention: ``pct_change().fillna(0)`` per asset (app.py:659-667).
    The leading all-zero row is intentional parity."""
    return np.concatenate([np.zeros((1, prices.shape[1])), stats_returns(prices)])


def annualized_moments(
    returns: np.ndarray, ann_factor: int
) -> tuple[np.ndarray, np.ndarray]:
    """(mean * ann, cov * ann), ddof=1 cov — app.py:679-680."""
    a = returns.shape[1]
    mean = returns.mean(axis=0) * ann_factor
    cov = np.cov(returns.T, ddof=1).reshape(a, a) * ann_factor
    return mean, cov


@dataclass(frozen=True)
class PriceData:
    """The fixed-shape array bundle handed to the JAX engine."""

    names: tuple[str, ...]
    prices: np.ndarray            # (T, A) resampled prices
    stats_rets: np.ndarray        # (T-1, A) pct_change().dropna()
    port_rets: np.ndarray         # (T, A) pct_change().fillna(0)
    mean_ann: np.ndarray          # (A,)  annualized mean of port_rets
    cov_ann: np.ndarray           # (A, A) annualized ddof=1 cov of port_rets
    ann_factor: int
    resample_rule: str
    dates: np.ndarray | None = None   # (T,) period-end labels, datetime64[D]

    @property
    def n_assets(self) -> int:
        return len(self.names)


def load_universe(
    paths: Sequence[str | Path] | None = None,
    named_series: Sequence[tuple[str, PriceSeries]] | None = None,
    config: DataConfig = DataConfig(),
    loader: str = "csv",
) -> PriceData:
    """Load CSVs (or pre-read series), join, resample and compute returns/moments.

    The asset name for a CSV path is the file stem up to the first '.'
    (app.py:389 uses ``file.name.split('.')[0]``). ``loader``: "csv" (default,
    the standard-library parser), "native" (C++ fast path, verified equal on
    fixtures), or "auto" (native when it builds).
    """
    if loader == "auto":
        from mcport.data.fast_loader import native_available

        loader = "native" if native_available() else "csv"
    if loader == "native":
        from mcport.data.fast_loader import read_csv_file_native as _read
    elif loader == "csv":
        _read = read_csv_file
    else:
        raise ValueError(f"unknown loader {loader!r}; expected csv|native|auto")

    pairs: list[tuple[str, PriceSeries]] = []
    if paths:
        for p in paths:
            p = Path(p)
            pairs.append((p.name.split(".")[0], _read(p, config)))
    if named_series:
        pairs.extend(named_series)
    if not pairs:
        raise ValueError("no price data provided")
    rule, ann = period_info(config.period)
    dates, prices = combine_prices(pairs, rule)
    prets = portfolio_returns(prices)
    mean_ann, cov_ann = annualized_moments(prets, ann)
    return PriceData(
        names=tuple(dedupe_names([t for t, _ in pairs])),
        prices=prices,
        stats_rets=stats_returns(prices),
        port_rets=prets,
        mean_ann=mean_ann,
        cov_ann=cov_ann,
        ann_factor=ann,
        resample_rule=rule,
        dates=dates,
    )
