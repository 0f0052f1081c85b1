"""Native C++ CSV fast path: builds, matches the csv loader and the reference's
pandas loader exactly, and is faster than pandas."""

import time

import numpy as np
import pytest

from mcport.config import DataConfig
from mcport.data import read_csv_file
from mcport.data.fast_loader import build_native, native_available, read_csv_file_native
from pandas_reference import read_csv_pandas, to_series_arrays

pytestmark = pytest.mark.skipif(
    not build_native(), reason="no C++ toolchain available"
)


def test_native_builds():
    assert native_available()


def test_matches_pandas_loader_on_all_fixtures(fixtures_dir):
    """Dates and prices identical to the csv loader and to pandas on every
    bundled CSV."""
    for p in sorted(fixtures_dir.glob("*.csv")):
        fast = read_csv_file_native(p)
        ref = read_csv_file(p)
        pd_dates, pd_prices = to_series_arrays(read_csv_pandas(p))
        np.testing.assert_array_equal(fast.dates, ref.dates)
        np.testing.assert_array_equal(fast.prices, ref.prices)
        np.testing.assert_array_equal(fast.dates, pd_dates)
        np.testing.assert_array_equal(fast.prices, pd_prices)


def test_bug_compat_mode(fixtures_dir):
    """strip_thousands=False drops comma prices, like pandas to_numeric coerce."""
    from mcport.data.csv_loader import CsvFormatError

    cfg = DataConfig(strip_thousands=False)
    with pytest.raises(CsvFormatError):
        read_csv_file_native(fixtures_dir / "BTC_USD 7 Years Weekly.csv", cfg)


def test_iso_dates(tmp_path):
    p = tmp_path / "iso.csv"
    p.write_text("Date,Close\n2024-01-02,10.5\n2024-01-03,11.25\nbad-row,x\n")
    s = read_csv_file_native(p)
    assert len(s) == 2
    assert s.prices.tolist() == [10.5, 11.25]
    assert s.dates[0] == np.datetime64("2024-01-02")


def test_native_faster_than_pandas(fixtures_dir, tmp_path):
    """On a large file the native parser beats the pandas path."""
    base = (fixtures_dir / "BTC_USD 7 Years Weekly.csv").read_text()
    header, rows = base.split("\n", 1)
    if not rows.endswith("\n"):
        rows += "\n"
    big = tmp_path / "big.csv"
    big.write_text(header + "\n" + rows * 60)  # ~22k rows
    read_csv_file_native(big)  # warm the lib

    t0 = time.perf_counter()
    fast = read_csv_file_native(big)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = read_csv_pandas(big)
    t_pandas = time.perf_counter() - t0
    assert len(fast) == len(ref)
    assert t_native < t_pandas, (t_native, t_pandas)
