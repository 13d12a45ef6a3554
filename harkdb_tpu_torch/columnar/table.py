"""Device-resident columnar Table.

The reference ships the whole host matrix across the FFI on *every* query
(``FutharkContext.py:65,70``). Here ``create_table`` pads and copies the
columns to the context's device once; queries run against the resident
tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.columnar.batch import ColumnBatch, align_capacity
from harkdb_tpu_torch.columnar.device import resolve_device
from harkdb_tpu_torch.columnar.ingest import load_table


class Table:
    """Named schema + padded device-resident columns.

    Mirrors the reference ``Table`` surface (``table.py:52-81``:
    get_schema / get_data / get_name) while storing true columnar data.
    ``device`` is where the columns live: ``"cuda"`` by default (raising
    when no CUDA device is available) or ``"cpu"``, as for ``Context``.
    """

    def __init__(self, table_name: str, source,
                 config: EngineConfig = DEFAULT_CONFIG,
                 col_names: Optional[List[str]] = None, device=None):
        device = resolve_device(device, "Table")
        host_cols, headers, dicts = load_table(source, config, col_names)
        self._init(table_name, host_cols, headers, dicts, config, device)

    @classmethod
    def from_host(cls, table_name: str, host_cols: Dict[str, np.ndarray],
                  headers: List[str], dicts: Dict[str, np.ndarray],
                  config: EngineConfig = DEFAULT_CONFIG,
                  device=None) -> "Table":
        """A table over already-ingested host columns (no re-encoding), on
        ``device`` (``"cuda"`` by default, as for ``Table``)."""
        device = resolve_device(device, "Table.from_host")
        t = cls.__new__(cls)
        t._init(table_name, dict(host_cols), list(headers), dict(dicts),
                config, device)
        return t

    def _init(self, table_name, host_cols, headers, dicts, config, device):
        self._table_name = table_name
        self._config = config
        self._schema = headers
        self._host_cols = host_cols          # unpadded host copies
        self._dicts = dicts                  # string col → sorted dictionary
                                             # (host-side; device sees codes)
        self._n_rows = len(next(iter(host_cols.values()))) if host_cols else 0
        self._device = device
        self._ranges: Dict[str, object] = {}
        cap = align_capacity(self._n_rows, config.row_align)
        cols = {}
        for name in headers:
            a = torch.from_numpy(np.ascontiguousarray(host_cols[name]))
            col = torch.zeros(cap, dtype=a.dtype, device=self._device)
            col[: self._n_rows].copy_(a)
            cols[name] = col
        self._columns = cols
        self._n_valid = torch.tensor(self._n_rows, dtype=torch.int32,
                                     device=self._device)

    # -- reference-compatible surface (table.py:64-81) ------------------------
    def get_schema(self) -> List[str]:
        return list(self._schema)

    def get_data(self) -> np.ndarray:
        """Dense 2-D row-major matrix of live rows (reference layout)."""
        return self.batch().to_numpy()[0]

    def get_name(self) -> str:
        return self._table_name

    # -- engine surface -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def capacity(self) -> int:
        if not self._columns:
            return 0
        return next(iter(self._columns.values())).shape[0]

    @property
    def columns(self) -> Dict[str, torch.Tensor]:
        return self._columns

    @property
    def host_columns(self) -> Dict[str, np.ndarray]:
        """Unpadded host copies (persistence and table hand-over)."""
        return self._host_cols

    def column_dict(self, name: str):
        """Sorted string dictionary of a dictionary-encoded column, or None
        for numeric columns. Codes are lexicographic ranks, so comparisons /
        ORDER BY / MIN / MAX on the device codes match string semantics."""
        return self._dicts.get(name)

    @property
    def dicts(self) -> Dict[str, np.ndarray]:
        return self._dicts

    def column_range(self, name: str):
        """(min, max) of an integer column, cached, from the host copy —
        the statistic a dense-key GROUP BY gate reads. None for
        float/empty columns."""
        if name not in self._ranges:
            a = self._host_cols[name]
            if a.size == 0 or not np.issubdtype(a.dtype, np.integer):
                self._ranges[name] = None
            else:
                self._ranges[name] = (int(a.min()), int(a.max()))
        return self._ranges[name]

    def batch(self) -> ColumnBatch:
        return ColumnBatch(dict(self._columns), self._n_valid)

    def nbytes(self) -> int:
        """Bytes of the padded device columns."""
        return sum(c.numel() * c.element_size()
                   for c in self._columns.values())

    def __repr__(self):
        return (f"Table({self._table_name!r}, rows={self._n_rows}, "
                f"cols={self._schema}, device={self._device})")


def tables_from_reference(tables, config: EngineConfig = DEFAULT_CONFIG,
                          device=None) -> Dict[str, Table]:
    """Take over a dict of the JAX package's tables (``harkdb_tpu`` Table
    objects) as tables of this package on ``device`` (``"cuda"`` by
    default, as for ``Table``).

    Duck-typed — reads only ``get_schema()``, ``host_columns`` and
    ``dicts`` — so this package never imports the JAX one. String columns
    keep their codes and dictionaries as they are.
    """
    device = resolve_device(device, "tables_from_reference")
    return {
        name: Table.from_host(name, t.host_columns, t.get_schema(), t.dicts,
                              config, device)
        for name, t in tables.items()
    }
