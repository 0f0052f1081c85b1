"""Data-layer tests: CSV loader semantics + pipeline parity on the bundled fixtures."""

import io

import numpy as np
import pandas as pd
import pytest

from mcport.config import DataConfig
from mcport.data import (
    CsvFormatError,
    PriceSeries,
    annualized_moments,
    combine_prices,
    dedupe_names,
    load_universe,
    portfolio_returns,
    read_csv_file,
    stats_returns,
    try_read_csv_file,
)


def _buf(text: str) -> io.BytesIO:
    return io.BytesIO(text.encode("utf-8"))


def test_reads_investing_format(fixtures_dir):
    """The bundled investing.com CSVs parse fully — including comma prices the
    reference loader silently drops (SURVEY.md §2 comma-price data loss)."""
    s = read_csv_file(fixtures_dir / "BTC_USD 7 Years Weekly.csv")
    assert s.dates.dtype == np.dtype("datetime64[s]") and s.prices.dtype == np.float64
    assert len(s) > 300  # 365 weekly rows; reference loses every price >= 1000
    assert s.prices.max() > 10_000  # comma-separated prices survived


def test_bug_compatible_mode(fixtures_dir):
    """strip_thousands=False reproduces the reference's data-loss behavior:
    BTC (all prices >= $1,000) loses every row and errors out; ETH keeps only
    its sub-$1,000 history."""
    cfg = DataConfig(strip_thousands=False)
    with pytest.raises(CsvFormatError):
        read_csv_file(fixtures_dir / "BTC_USD 7 Years Weekly.csv", cfg)
    s = read_csv_file(fixtures_dir / "ETH_USD 7 Years Weekly.csv", cfg)
    assert s.prices.max() < 1_000
    full = read_csv_file(fixtures_dir / "ETH_USD 7 Years Weekly.csv")
    assert len(s) < len(full)


def test_all_fixture_csvs_load(fixtures_dir):
    for p in sorted(fixtures_dir.glob("*.csv")):
        s = read_csv_file(p)
        assert len(s) > 10, p.name
        assert np.isfinite(s.prices).all()


def test_header_sniff():
    """Header row found within the first 5 rows (app.py:99-109)."""
    raw = "junk1,junk2\nmeta,stuff\nDate,Close\n2024-01-01,10\n2024-01-02,11\n"
    s = read_csv_file(_buf(raw))
    assert len(s) == 2
    assert s.prices.tolist() == [10.0, 11.0]


def test_price_column_file_order():
    """First matching price column in file order wins (app.py:115-120)."""
    raw = "Date,Open,Close\n2024-01-01,1,2\n2024-01-02,3,4\n"
    s = read_csv_file(_buf(raw))
    assert s.prices.tolist() == [1.0, 3.0]  # Open comes first in the file


def test_fallback_non_date_column():
    raw = "Date,Whatever\n2024-01-01,5\n2024-01-02,6\n"
    s = read_csv_file(_buf(raw))
    assert s.prices.tolist() == [5.0, 6.0]


def test_missing_date_column_raises():
    with pytest.raises(CsvFormatError):
        read_csv_file(_buf("a,b\n1,2\n"))
    df, err = try_read_csv_file(_buf("a,b\n1,2\n"))
    assert df is None and err


def test_dedupe_names():
    assert dedupe_names(["BTC", "ETH", "BTC", "BTC"]) == ["BTC", "ETH", "BTC (2)", "BTC (3)"]


@pytest.fixture(scope="module")
def two_asset(fixtures_dir):
    return load_universe(
        paths=[
            fixtures_dir / "BTC_USD 7 Years Weekly.csv",
            fixtures_dir / "ETH_USD 7 Years Weekly.csv",
        ],
        config=DataConfig(period="W"),
    )


def test_load_universe_shapes(two_asset):
    d = two_asset
    assert d.n_assets == 2
    assert d.prices.shape[1] == 2
    assert d.port_rets.shape[0] == d.prices.shape[0]       # fillna(0) keeps first row
    assert d.stats_rets.shape[0] == d.prices.shape[0] - 1  # dropna drops first row
    assert np.allclose(d.port_rets[0], 0.0)                # leading zero row parity
    assert d.ann_factor == 52


def test_moments_match_pandas(two_asset):
    """mean*ann / cov*ann match pandas semantics exactly (app.py:679-680)."""
    d = two_asset
    rets = pd.DataFrame(d.port_rets)
    np.testing.assert_allclose(d.mean_ann, rets.mean().to_numpy() * 52, atol=1e-12)
    np.testing.assert_allclose(d.cov_ann, rets.cov().to_numpy() * 52, atol=1e-12)


def test_combine_inner_join():
    idx1 = np.arange("2024-01-01", "2024-01-11", dtype="datetime64[D]")
    a = PriceSeries(idx1.astype("datetime64[s]"), np.arange(10.0) + 1)
    b = PriceSeries((idx1 + 2).astype("datetime64[s]"), np.arange(10.0) + 100)
    dates, joined = combine_prices([("A", a), ("B", b)], "D")
    assert dates[0] == np.datetime64("2024-01-03")
    assert joined.shape == (8, 2)


def test_returns_conventions():
    prices = np.array([[100.0], [110.0], [99.0], [99.0]])
    sr = stats_returns(prices)
    pr = portfolio_returns(prices)
    assert len(sr) == 3 and len(pr) == 4
    assert pr[0, 0] == 0.0
    np.testing.assert_allclose(sr[:, 0], [0.1, -0.1, 0.0], atol=1e-12)
