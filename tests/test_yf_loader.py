"""yfinance extractor semantics (app.py:136-162) on synthetic frames — no network."""

import numpy as np
import pandas as pd

from mcport.data.yf_loader import download_prices, get_price_dataframe_from_yf


def _dates(n=5):
    return pd.date_range("2024-01-01", periods=n, freq="D")


def test_multiindex_extraction():
    cols = pd.MultiIndex.from_product([["BTC-USD", "ETH-USD"], ["Close", "Open"]])
    data = pd.DataFrame(np.arange(20.0).reshape(5, 4), index=_dates(), columns=cols)
    data.index.name = "Date"
    df, err = get_price_dataframe_from_yf(data, "BTC-USD")
    assert err is None
    assert list(df.columns) == ["Date", "Price"]
    np.testing.assert_allclose(df["Price"], data[("BTC-USD", "Close")].to_numpy())


def test_multiindex_missing_ticker():
    cols = pd.MultiIndex.from_product([["BTC-USD"], ["Close"]])
    data = pd.DataFrame(np.ones((5, 1)), index=_dates(), columns=cols)
    df, err = get_price_dataframe_from_yf(data, "DOGE-USD")
    assert df is None and "DOGE-USD" in err


def test_flat_columns_price_priority():
    """Close > Adj Close > Open (app.py:140,154)."""
    data = pd.DataFrame(
        {"Open": [1.0] * 5, "Adj Close": [2.0] * 5, "Close": [3.0] * 5},
        index=_dates(),
    )
    data.index.name = "Date"
    df, err = get_price_dataframe_from_yf(data, "X")
    assert err is None
    assert (df["Price"] == 3.0).all()   # Close wins
    df2, _ = get_price_dataframe_from_yf(data.drop(columns=["Close"]), "X")
    assert (df2["Price"] == 2.0).all()  # then Adj Close
    df3, _ = get_price_dataframe_from_yf(data.drop(columns=["Close", "Adj Close"]), "X")
    assert (df3["Price"] == 1.0).all()  # then Open


def test_flat_columns_no_price_column():
    data = pd.DataFrame({"Volume": [1.0] * 3}, index=_dates(3))
    df, err = get_price_dataframe_from_yf(data, "X")
    from mcport.data.messages import MSG
    assert df is None and err == MSG["yf_no_price_col"].format(ticker="X")


def test_download_prices_gated_without_yfinance():
    """yfinance is absent here: every ticker reports a recoverable error."""
    out = download_prices(["BTC-USD", "  ", "ETH-USD"])
    assert [t for t, _, _ in out] == ["BTC-USD", "ETH-USD"]
    for _, df, err in out:
        assert df is None and err
