"""Table ingest: CSV / txt / pandas DataFrame / numpy ndarray → columnar data.

Mirrors the reference's dispatch shape (``table.py:42-50``: DataFrame / ndarray
/ file-path string) and its error behavior (unsupported file type and
unsupported source raise, ``table.py:40,50``), but produces *columnar* host
arrays with a normalized dtype policy (int32/float32) instead of one row-major
int matrix (``table.py:60-62``).

String columns (beyond the numeric-only reference) are **dictionary-encoded at
ingest**: each string column becomes an int32 code column plus a host-side
sorted dictionary of its distinct values. Codes are assigned in lexicographic
order, so ``<``/``<=``/``>``/``>=``/ORDER BY/MIN/MAX on codes match string
semantics exactly — the device only ever sees dense int32. Every loader returns
``(columns, headers, dicts)`` where ``dicts`` maps column name → np.ndarray of
strings (absent for numeric columns).

pandas is imported only by the loaders that need it (a CSV with text cells,
parquet, and a DataFrame source); dict and ndarray sources and all-numeric
CSVs (``io/native_csv.py``) work without it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import sys

import numpy as np

from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG

HostColumns = Dict[str, np.ndarray]
ColumnDicts = Dict[str, np.ndarray]      # column name → sorted string values
LoadResult = Tuple[HostColumns, List[str], ColumnDicts]


def encode_strings(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Order-preserving dictionary encoding: values → (int32 codes, sorted
    dictionary). ``dictionary[codes]`` reconstructs the input; codes compare
    like the strings they stand for (np.unique returns sorted uniques)."""
    vals = np.asarray(a, dtype=str)
    dictionary, codes = np.unique(vals, return_inverse=True)
    return codes.astype(np.int32), dictionary


def _is_string_like(a: np.ndarray) -> bool:
    return a.dtype == object or np.issubdtype(a.dtype, np.str_)


def _normalize_dtype(a: np.ndarray, config: EngineConfig) -> np.ndarray:
    """Dtype policy: integers → int_dtype, floats → float_dtype.

    The reference is inconsistent (i32 in select.fut:23, u32 in groupby.fut:51,
    i64 from pandas); we normalize once at ingest.
    """
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(config.float_dtype)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return a.astype(config.int_dtype)
    raise TypeError(
        f"Unsupported column dtype {a.dtype}; only numeric and string "
        f"columns are supported"
    )


def _normalize_col(
    name: str, a: np.ndarray, config: EngineConfig, dicts: ColumnDicts
) -> np.ndarray:
    if _is_string_like(a):
        codes, dictionary = encode_strings(a)
        dicts[name] = dictionary
        return codes
    return _normalize_dtype(a, config)


def load_df(df, config: EngineConfig) -> LoadResult:
    # Reference: table.py:8-10 (df.to_numpy(), list(df)).
    headers = [str(c) for c in df.columns]
    dicts: ColumnDicts = {}
    cols = {
        h: _normalize_col(h, df[c].to_numpy(), config, dicts)
        for h, c in zip(headers, df.columns)
    }
    return cols, headers, dicts


def load_np(
    arr: np.ndarray, config: EngineConfig, col_names: Optional[List[str]] = None
) -> LoadResult:
    # Reference: table.py:12-16 — 2-D row-major matrix, autogen col1..colN.
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"Expected a 2-D table, got shape {arr.shape}")
    n_cols = arr.shape[1]
    headers = col_names or [f"col{i + 1}" for i in range(n_cols)]
    if len(headers) != n_cols:
        raise ValueError(f"{len(headers)} names for {n_cols} columns")
    dicts: ColumnDicts = {}
    cols = {
        h: _normalize_col(h, np.ascontiguousarray(arr[:, i]), config, dicts)
        for i, h in enumerate(headers)
    }
    return cols, headers, dicts


def load_csv(path: str, config: EngineConfig) -> LoadResult:
    # Reference: table.py:29-32 (pd.read_csv). The native loader reads an
    # all-numeric file; pandas only one with text cells (string columns
    # dictionary-encode in load_df).
    from harkdb_tpu_torch.io.native_csv import native_read_csv

    result = native_read_csv(path, config)
    if result is not None:
        cols, names = result
        return cols, names, {}
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            f"loading {path!r} needs pandas, which is not installed: only "
            f"all-numeric CSVs load without pandas"
        ) from e
    df = pd.read_csv(path, skipinitialspace=True)
    return load_df(df, config)


def load_txt(
    path: str, config: EngineConfig, col_names: Optional[List[str]] = None
) -> LoadResult:
    # Reference: table.py:33-39 (np.loadtxt, autogen c1..cN names).
    arr = np.loadtxt(path)
    if arr.ndim == 1:
        arr = arr[:, None]
    headers = col_names or [f"c{i + 1}" for i in range(arr.shape[1])]
    return load_np(arr, config, headers)


def load_file(
    path: str, config: EngineConfig, col_names: Optional[List[str]] = None
) -> LoadResult:
    if path.endswith(".csv"):
        return load_csv(path, config)
    if path.endswith(".txt"):
        return load_txt(path, config, col_names)
    if path.endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(path)
        return load_df(df, config)
    # Reference error contract: table.py:40.
    raise Exception("We do not support loading this file type")


def load_table(source, config: EngineConfig = DEFAULT_CONFIG,
               col_names: Optional[List[str]] = None) -> LoadResult:
    """Dispatch on source type — DataFrame / ndarray / path (table.py:42-50).
    A DataFrame can only exist if pandas is already imported, so the check
    reads ``sys.modules`` instead of importing it."""
    pd = sys.modules.get("pandas")
    if pd is not None and isinstance(source, pd.DataFrame):
        return load_df(source, config)
    if isinstance(source, np.ndarray):
        return load_np(source, config, col_names)
    if isinstance(source, dict):
        headers = [str(k) for k in source.keys()]
        dicts: ColumnDicts = {}
        cols = {
            h: _normalize_col(h, np.asarray(v), config, dicts)
            for h, v in zip(headers, source.values())
        }
        return cols, headers, dicts
    if isinstance(source, str):
        return load_file(source, config, col_names)
    # Reference error contract: table.py:50.
    raise Exception("Table is not in a file, numpy array or dataframe")
