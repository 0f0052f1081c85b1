"""The reference's pandas ingestion (app.py:89-134, 466-482, 288-298, 659-680),
kept in the test suite as the oracle for mcport's NumPy/csv data layer.

This is the pandas form mcport used to run itself; the package no longer
imports pandas on its main path, so the tests hold the two to the same
results (tests/test_csv_parity.py, tests/test_fast_loader.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mcport.config import DataConfig, period_info
from mcport.data.csv_loader import CsvFormatError
from mcport.data.messages import MSG


def _read_raw(file, **kwargs) -> pd.DataFrame:
    if hasattr(file, "seek"):
        file.seek(0)
    return pd.read_csv(file, **kwargs)


def _norm(name: object) -> str:
    return str(name).strip().lower()


def read_csv_pandas(file, config: DataConfig = DataConfig()) -> pd.DataFrame:
    """``DataFrame[Date, Price]`` with the reference loader's semantics."""
    df_try = _read_raw(file)
    if any(_norm(c) == "date" for c in df_try.columns):
        df = df_try.copy()
    else:
        df = _read_raw(file, header=None)
        header_idx = None
        for i in range(min(config.header_scan_rows, len(df))):
            row = [_norm(x) for x in df.iloc[i].tolist()]
            if any(x == "date" for x in row):
                header_idx = i
                break
        if header_idx is None:
            raise CsvFormatError(MSG["no_header"])
        header_row = df.iloc[header_idx].tolist()
        df = df.iloc[header_idx + 1:].reset_index(drop=True)
        df.columns = header_row

    date_col = [c for c in df.columns if _norm(c) == "date"][0]
    price_candidates = [c for c in df.columns if _norm(c) in config.price_priority]
    if not price_candidates:
        price_candidates = [c for c in df.columns if c != date_col]
    price_col = price_candidates[0]

    df = df[[date_col, price_col]].dropna()
    if df.empty:
        raise CsvFormatError(MSG["empty_after_dropna"])
    df = df.rename(columns={date_col: "Date", price_col: "Price"})
    df["Date"] = pd.to_datetime(df["Date"], errors="coerce", format="mixed")
    price = df["Price"]
    if config.strip_thousands and not pd.api.types.is_numeric_dtype(price):
        price = price.astype(str).str.replace(",", "", regex=False)
    df["Price"] = pd.to_numeric(price, errors="coerce")
    df = df.dropna(subset=["Date", "Price"])
    if df.empty:
        raise CsvFormatError(MSG["empty_after_coerce"])
    return df.reset_index(drop=True)


def universe_pandas(paths, period: str):
    """(resampled prices frame, stats returns, portfolio returns, mean_ann,
    cov_ann) exactly as the reference assembles them."""
    rule, ann = period_info(period)
    frames = []
    for p in paths:
        df = read_csv_pandas(p)
        name = Path(p).name.split(".")[0]
        frames.append(df.rename(columns={"Price": name}).set_index("Date")[[name]])
    prices = pd.concat(frames, axis=1, join="inner").sort_index()
    resampled = prices.resample(rule).last().dropna()
    srets = resampled.pct_change().dropna()
    prets = resampled.pct_change().fillna(0.0).dropna()
    return (resampled, srets, prets, prets.mean().to_numpy() * ann,
            prets.cov().to_numpy() * ann)


def to_series_arrays(df: pd.DataFrame) -> tuple[np.ndarray, np.ndarray]:
    return (df["Date"].to_numpy().astype("datetime64[s]"),
            df["Price"].to_numpy(np.float64))
