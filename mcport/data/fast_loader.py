"""Native (C++) CSV fast path — ctypes binding over ``mcport/_native/fastcsv``.

Division of labor: Python keeps the *semantic* work it does once per file
(header sniffing, column selection — the reference's exact rules,
:func:`mcport.data.csv_loader.find_columns`); the C++ unit does the per-row hot
work (quoted splitting, thousands stripping, date/float parsing). Output is
verified equal to the csv loader and to pandas on every bundled fixture
(tests/test_fast_loader.py).

The shared library builds on demand with ``make -C mcport/_native``; without
a compiler, ``load_universe(loader="auto")`` uses the csv loader — the fast
path is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from mcport.config import DataConfig
from mcport.data.csv_loader import (
    CsvFormatError,
    PriceSeries,
    _rows,
    find_columns,
)

__all__ = ["native_available", "read_csv_file_native", "build_native"]

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "_native"
_LIB_PATH = _NATIVE_DIR / "libfastcsv.so"
_lib = None


def build_native(force: bool = False) -> bool:
    """Compile the shared library if needed. Returns availability."""
    if _LIB_PATH.exists() and not force:
        return True
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)] + (["-B"] if force else []),
            check=True, capture_output=True, timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not build_native():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.mc_parse_csv.restype = ctypes.c_long
    lib.mc_parse_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def read_csv_file_native(
    path: str | Path, config: DataConfig = DataConfig()
) -> PriceSeries:
    """Native-parsed equivalent of :func:`mcport.data.csv_loader.read_csv_file`.

    Raises :class:`CsvFormatError` on format problems; raises RuntimeError when
    the native library cannot be built (callers should use the csv loader).
    """
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("native fastcsv library unavailable (no compiler?)")
    path = Path(path)
    buf = path.read_bytes()
    lines = buf.split(b"\n", config.header_scan_rows)[:config.header_scan_rows]
    head = _rows(b"\n".join(lines).decode("utf-8-sig"))
    date_col, price_col, skip = find_columns(head, config)

    max_rows = buf.count(b"\n") + 2
    days = np.empty(max_rows, np.int64)
    prices = np.empty(max_rows, np.float64)
    n = lib.mc_parse_csv(
        buf, len(buf), date_col, price_col, skip,
        1 if config.strip_thousands else 0,
        days.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        prices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows,
    )
    if n < 0:
        raise CsvFormatError(f"native parser rejected {path.name}")
    if n == 0:
        raise CsvFormatError("no valid rows left after type coercion")
    return PriceSeries(days[:n].astype("datetime64[D]").astype("datetime64[s]"),
                       prices[:n].copy())
