from mcport.data.csv_loader import (
    CsvFormatError,
    PriceSeries,
    read_csv_file,
    try_read_csv_file,
)
from mcport.data.fast_loader import build_native, native_available, read_csv_file_native
from mcport.data.pipeline import (
    PriceData,
    annualized_moments,
    combine_prices,
    dedupe_names,
    load_universe,
    portfolio_returns,
    stats_returns,
)

__all__ = [
    "read_csv_file",
    "try_read_csv_file",
    "CsvFormatError",
    "PriceSeries",
    "combine_prices",
    "dedupe_names",
    "stats_returns",
    "portfolio_returns",
    "annualized_moments",
    "load_universe",
    "PriceData",
    "read_csv_file_native",
    "native_available",
    "build_native",
]
