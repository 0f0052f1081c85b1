"""The NumPy/csv data layer against the reference's pandas pipeline
(tests/pandas_reference.py) on every bundled fixture and every resample rule:
same rows, same resampled prices, same returns, same annualized moments."""

from pathlib import Path

import numpy as np
import pytest

from mcport.config import DataConfig
from mcport.data import load_universe, read_csv_file
from pandas_reference import read_csv_pandas, to_series_arrays, universe_pandas

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
ALL = sorted(p.name for p in FIXTURES.glob("*.csv"))
WEEKLY = [n for n in ALL if "Weekly" in n]
DAILY = [n for n in ALL if n not in WEEKLY]
PERIODS = ["D", "W", "M", "Q"]      # → resample rules D / W / ME / QE


def _check(paths, period):
    d = load_universe(paths=paths, config=DataConfig(period=period))
    resampled, srets, prets, mean_ann, cov_ann = universe_pandas(paths, period)
    assert d.prices.shape == resampled.shape
    np.testing.assert_array_equal(d.prices, resampled.to_numpy(np.float64))
    np.testing.assert_array_equal(
        d.dates, resampled.index.to_numpy().astype("datetime64[D]"))
    np.testing.assert_allclose(d.stats_rets, srets.to_numpy(np.float64),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(d.port_rets, prets.to_numpy(np.float64),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(d.mean_ann, mean_ann, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(d.cov_ann, cov_ann, rtol=1e-10, atol=1e-15)


@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("name", ALL)
def test_fixture_matches_pandas_pipeline(name, period):
    p = FIXTURES / name
    got = read_csv_file(p)
    dates, prices = to_series_arrays(read_csv_pandas(p))
    np.testing.assert_array_equal(got.dates, dates)
    np.testing.assert_array_equal(got.prices, prices)
    _check([p], period)


@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("group", ["daily", "weekly"])
def test_joined_universe_matches_pandas_pipeline(group, period):
    """The largest fixture sets that inner-join: the 14 daily-dated files and
    the 2 weekly ones."""
    names = DAILY if group == "daily" else WEEKLY
    _check([FIXTURES / n for n in names], period)
