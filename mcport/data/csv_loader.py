"""CSV ingestion with the reference loader's exact semantics (app.py:89-134),
on the standard-library ``csv`` module and NumPy.

Behavioral parity with ``read_csv_file``:

1. Read with the first row as header; if no column is literally named
   (case/space-insensitively) ``date``, scan the first 5 rows for a cell equal
   to ``date`` and use that row as the header (app.py:99-109).
2. The date column is the first whose stripped-lowercase name == 'date' (app.py:111).
3. Price candidates are columns named price/close/adj close/open **in column order**
   (the reference takes ``price_candidates[0]``, i.e. the first matching column as
   laid out in the file, not a fixed priority ranking — app.py:115-120); when none
   match, every non-date column is a candidate.
4. Keep (date, price) only, drop missing cells, coerce types, drop rows that
   fail coercion (app.py:121-130). Dates parse as pandas' ``format="mixed"``
   does for the layouts such files use (ISO, month-first ``MM/DD/YYYY``,
   ``YYYY/MM/DD``, ``Mon DD, YYYY``).

**Documented divergence (fix):** the reference feeds raw strings to
``pd.to_numeric(errors='coerce')`` (app.py:127), which nulls every price containing
a thousands separator — its own bundled investing.com CSVs (e.g. ``"86,493.0"``)
lose most rows ≥ 1,000 (SURVEY.md §2 "comma-price data loss"). mcport strips
thousands separators before coercion (``DataConfig.strip_thousands``, on by default;
set False for bug-compatible behavior).

Errors are raised as :class:`CsvFormatError` carrying the same failure conditions the
reference reports via ``st.error`` (app.py:132-134); ``try_read_csv_file`` gives the
(series | None, err | None) form used at UI boundaries.
"""

from __future__ import annotations

import csv
import io
import os
import re
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import IO, Union

import numpy as np

from mcport.config import DataConfig
from mcport.data.messages import MSG

__all__ = ["CsvFormatError", "PriceSeries", "read_csv_file", "try_read_csv_file",
           "find_columns", "parse_date"]

FileLike = Union[str, os.PathLike, IO[bytes], IO[str]]

# pandas.read_csv's default missing-value tokens (exact cell matches)
_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


class CsvFormatError(ValueError):
    """A CSV could not be normalized to a (Date, Price) series.

    Mirrors the recoverable ingestion errors of app.py:106,113,119,123,130 with the
    reference's exact Persian messages (:mod:`mcport.data.messages`) — callers
    should skip the asset and continue (SURVEY.md §5 failure-detection semantics).
    """


@dataclass(frozen=True)
class PriceSeries:
    """One asset's (date, price) rows in file order."""

    dates: np.ndarray      # datetime64[s]
    prices: np.ndarray     # float64

    def __len__(self) -> int:
        return len(self.prices)


def _norm(name: object) -> str:
    return str(name).strip().lower()


def _read_text(file: FileLike) -> str:
    if hasattr(file, "read"):
        if hasattr(file, "seek"):
            file.seek(0)  # the reference rewinds before each read (app.py:91,97)
        data = file.read()
    else:
        data = Path(file).read_bytes()
    if isinstance(data, bytes):
        return data.decode("utf-8-sig")
    return data.lstrip("\ufeff")


def _rows(text: str) -> list[list[str]]:
    """Non-blank CSV rows (pandas skips blank lines)."""
    return [r for r in csv.reader(io.StringIO(text, newline="")) if r]


def find_columns(rows: list[list[str]], config: DataConfig) -> tuple[int, int, int]:
    """(date column, price column, first data row) by the reference's rules
    (app.py:99-120)."""
    header_idx = 0 if rows and any(_norm(c) == "date" for c in rows[0]) else None
    if header_idx is None:
        for i, row in enumerate(rows[:config.header_scan_rows]):
            if any(_norm(c) == "date" for c in row):
                header_idx = i
                break
    if header_idx is None:
        raise CsvFormatError(MSG["no_header"])
    header = [_norm(c) for c in rows[header_idx]]
    date_col = header.index("date")
    # first matching column in file order, exactly like app.py:115-120
    price_cols = [j for j, c in enumerate(header) if c in config.price_priority]
    if not price_cols:
        price_cols = [j for j in range(len(header)) if j != date_col]
    if not price_cols:
        raise CsvFormatError(MSG["no_price_col"])
    return date_col, price_cols[0], header_idx + 1


_US = re.compile(r"(\d{1,2})/(\d{1,2})/(\d{4})(?:[ T](\d{1,2}):(\d{2})(?::(\d{2}))?)?")
_YMD = re.compile(r"(\d{4})/(\d{1,2})/(\d{1,2})")
_WORDY = ("%b %d, %Y", "%B %d, %Y", "%d %b %Y", "%d %B %Y", "%b %d %Y")


def parse_date(text: str) -> np.datetime64 | None:
    """A date cell as datetime64[s], or None when it does not parse
    (``pd.to_datetime(errors="coerce", format="mixed")`` semantics for the
    layouts above; month-first unless the month field exceeds 12)."""
    s = text.strip()
    dt = None
    try:
        dt = datetime.fromisoformat(s)
    except ValueError:
        if m := _US.fullmatch(s):
            mo, d, y = int(m[1]), int(m[2]), int(m[3])
            if mo > 12 >= d:
                mo, d = d, mo
            hh, mm, ss = (int(x) if x else 0 for x in (m[4], m[5], m[6]))
            try:
                dt = datetime(y, mo, d, hh, mm, ss)
            except ValueError:
                return None
        elif m := _YMD.fullmatch(s):
            try:
                dt = datetime(int(m[1]), int(m[2]), int(m[3]))
            except ValueError:
                return None
        else:
            for fmt in _WORDY:
                try:
                    dt = datetime.strptime(s, fmt)
                    break
                except ValueError:
                    pass
    if dt is None:
        return None
    return np.datetime64(dt.replace(tzinfo=None), "s")


def _parse_price(text: str, strip_thousands: bool) -> float | None:
    s = text.replace(",", "") if strip_thousands else text
    if "_" in s:        # float() accepts digit separators; to_numeric does not
        return None
    try:
        return float(s)
    except ValueError:
        return None


def read_csv_file(file: FileLike, config: DataConfig = DataConfig()) -> PriceSeries:
    """Normalize an uploaded CSV into a :class:`PriceSeries`.

    Raises :class:`CsvFormatError` on any unrecoverable format problem.
    """
    rows = _rows(_read_text(file))
    date_col, price_col, first = find_columns(rows, config)
    cells = [
        (r[date_col], r[price_col]) for r in rows[first:]
        if max(date_col, price_col) < len(r)
        and r[date_col] not in _NA and r[price_col] not in _NA
    ]
    if not cells:
        raise CsvFormatError(MSG["empty_after_dropna"])
    dates, prices = [], []
    for d_txt, p_txt in cells:
        d = parse_date(d_txt)
        p = _parse_price(p_txt, config.strip_thousands)
        if d is not None and p is not None and p == p:
            dates.append(d)
            prices.append(p)
    if not dates:
        raise CsvFormatError(MSG["empty_after_coerce"])
    return PriceSeries(np.asarray(dates, "datetime64[s]"),
                       np.asarray(prices, np.float64))


def try_read_csv_file(
    file: FileLike, config: DataConfig = DataConfig()
) -> tuple[PriceSeries | None, str | None]:
    """Non-raising variant returning (series, None) or (None, error message)."""
    try:
        return read_csv_file(file, config), None
    except Exception as e:  # the reference catches everything
        return None, str(e)
