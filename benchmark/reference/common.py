"""Plain NumPy building blocks of the reference answers.

The configurations state int32 arithmetic: a sum wraps as int32 sums do,
and an average is float32(the wrapped sum) / float32(the count). Every sum
here is exact (two 16-bit halves, each summed exactly in float64) and then
wrapped, which gives what any int32 adder gives, in any order.

``Ref`` caches what several templates need: a column's dictionary codes
(sorted order, as a dictionary encoding gives them) and key -> row maps.
With ``control`` set, every sum is rounded to float32 first: the reference
computed one precision below the one the configuration states, which the
comparison has to refuse.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MOD = 1 << 32


def wrap32(x) -> np.ndarray:
    """Exact integers wrapped to int32."""
    x = np.asarray(x, dtype=np.int64)
    return ((x + (1 << 31)) % MOD - (1 << 31)).astype(np.int32)


class Ref:
    def __init__(self, tables: Dict[str, Dict[str, np.ndarray]],
                 control: bool = False):
        self.t = tables
        self.control = control
        self._codes: Dict[tuple, np.ndarray] = {}
        self._rows: Dict[tuple, np.ndarray] = {}

    def col(self, table: str, name: str) -> np.ndarray:
        return self.t[table][name]

    def codes(self, table: str, name: str) -> np.ndarray:
        """The int32 code of each row's string: its rank among the
        column's distinct strings in sorted order."""
        key = (table, name)
        if key not in self._codes:
            _u, inv = np.unique(self.t[table][name], return_inverse=True)
            self._codes[key] = inv.astype(np.int32)
        return self._codes[key]

    def code_of(self, table: str, name: str, value: str) -> int:
        """The code ``value`` has in the column, or -1 if absent."""
        u = np.unique(self.t[table][name])
        i = int(np.searchsorted(u, value))
        return i if i < u.size and u[i] == value else -1

    def rows(self, table: str, key: str) -> np.ndarray:
        """Key -> row map of a table's unique integer key (-1: no row)."""
        k = (table, key)
        if k not in self._rows:
            keys = self.t[table][key].astype(np.int64)
            lut = np.full(int(keys.max()) + 1, -1, np.int64)
            lut[keys] = np.arange(keys.size)
            self._rows[k] = lut
        return self._rows[k]

    def row_of(self, table: str, key: str, values: np.ndarray) -> np.ndarray:
        lut = self.rows(table, key)
        v = values.astype(np.int64)
        out = np.full(v.shape, -1, np.int64)
        ok = (v >= 0) & (v < lut.size)
        out[ok] = lut[v[ok]]
        return out

    # -- grouped sums ----------------------------------------------------------
    def gsum(self, group: np.ndarray, values: np.ndarray,
             n_groups: int) -> np.ndarray:
        """int32 sum of ``values`` per group id in ``[0, n_groups)``."""
        v = np.asarray(values).astype(np.int64)
        if self.control:
            s = np.bincount(group, weights=v.astype(np.float64),
                            minlength=n_groups)
            return wrap32(np.rint(s.astype(np.float32)).astype(np.int64))
        v = v % MOD
        lo = np.bincount(group, weights=(v & 0xFFFF).astype(np.float64),
                         minlength=n_groups)
        hi = np.bincount(group, weights=(v >> 16).astype(np.float64),
                         minlength=n_groups)
        return wrap32(hi.astype(np.int64) * 65536 + lo.astype(np.int64))

    def total(self, values: np.ndarray) -> np.int32:
        """int32 sum of all ``values``."""
        return self.gsum(np.zeros(np.asarray(values).size, np.int64),
                         values, 1)[0]

    @staticmethod
    def count(group: np.ndarray, n_groups: int) -> np.ndarray:
        return np.bincount(group, minlength=n_groups).astype(np.int64)

    @staticmethod
    def avg(wrapped_sum: np.ndarray, count: np.ndarray) -> np.ndarray:
        """float32(the wrapped int32 sum) / float32(the count)."""
        return (wrapped_sum.astype(np.float32)
                / np.asarray(count).astype(np.float32))


def radix_key(parts, sizes) -> np.ndarray:
    """One int64 group id per row from small non-negative parts, the first
    part most significant: ascending ids order the groups as the parts
    order lexicographically."""
    key = np.zeros(np.asarray(parts[0]).shape, np.int64)
    for p, n in zip(parts, sizes):
        key = key * int(n) + np.asarray(p, np.int64)
    return key


def order_rows(columns, keys) -> np.ndarray:
    """Stable sort of result rows: ``keys`` is a list of (column index,
    descending) pairs, the first the primary key; ties keep the rows'
    order."""
    lex = []
    for idx, desc in reversed(keys):
        c = np.asarray(columns[idx]).astype(np.float64)
        lex.append(-c if desc else c)
    return np.lexsort(lex) if lex else np.arange(len(columns[0]))


def matrix(columns, dtype) -> np.ndarray:
    """Result columns stacked as the engine's ``sql`` returns them."""
    if not columns:
        return np.zeros((0, 0), dtype)
    return np.stack([np.asarray(c) for c in columns], axis=1).astype(dtype)
