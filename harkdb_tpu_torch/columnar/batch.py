"""ColumnBatch — the padded unit of data flowing through operators.

SQL operators (WHERE, GROUP BY, DISTINCT) produce data-dependent row
counts. The engine-wide convention, kept from the JAX package: every
intermediate is a *padded* set of equal-length 1-D columns plus a count
``n_valid``. Rows at index >= n_valid are padding and carry no meaning;
operators must mask them. ``n_valid`` is a 0-d int32 tensor on the columns'
device, so an operator chain never waits for the host; only the planner's
deliberate readbacks (and ``to_numpy``) synchronise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from harkdb_tpu_torch.columnar.device import resolve_device
from harkdb_tpu_torch.utils.metrics import host_read


class ColumnBatch:
    """An ordered set of named, equal-capacity 1-D tensors + valid count.

    ``columns`` preserves insertion order — column order is observable in
    query output (reference keeps requested select order,
    ``select.fut:17-20``).
    """

    def __init__(self, columns: Dict[str, torch.Tensor],
                 n_valid: torch.Tensor):
        self.columns = dict(columns)
        self.n_valid = n_valid

    # -- structure ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return self.n_valid.device

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of shape (capacity,): True for live rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.n_valid

    def with_columns(self, columns: Dict[str, torch.Tensor]) -> "ColumnBatch":
        return ColumnBatch(columns, self.n_valid)

    def select(self, names) -> "ColumnBatch":
        """Projection: keep `names` in order."""
        return ColumnBatch({n: self.columns[n] for n in names}, self.n_valid)

    def rename(self, mapping: Dict[str, str]) -> "ColumnBatch":
        return ColumnBatch(
            {mapping.get(n, n): c for n, c in self.columns.items()},
            self.n_valid)

    # -- host conversion ------------------------------------------------------
    def to_numpy(self) -> Tuple[np.ndarray, List[str]]:
        """Materialize as a dense 2-D row-major matrix + header list (the
        reference's output shape, ``FutharkContext.py:66,71``). Syncs."""
        names = self.names
        with host_read("result"):
            n = int(self.n_valid)
            if not names:
                return np.empty((n, 0)), names
            cols = [self.columns[c][:n].cpu().numpy() for c in names]
        return np.stack(cols, axis=1), names

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], capacity: int | None = None,
                   device=None) -> "ColumnBatch":
        """Build a padded batch on ``device`` from host 1-D arrays:
        ``"cuda"`` by default (raising when no CUDA device is available) or
        ``"cpu"``, as for ``Context``."""
        device = resolve_device(device, "ColumnBatch.from_numpy")
        if not arrays:
            return ColumnBatch({}, torch.zeros((), dtype=torch.int32,
                                               device=device))
        n = len(next(iter(arrays.values())))
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} rows")
        cols = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            if a.ndim != 1 or a.shape[0] != n:
                raise ValueError(f"column {name!r} has shape {a.shape}, "
                                 f"expected ({n},)")
            if cap > n:
                a = np.concatenate([a, np.zeros(cap - n, dtype=a.dtype)])
            cols[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return ColumnBatch(cols, torch.tensor(n, dtype=torch.int32,
                                              device=device))

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}" for n, c in self.columns.items())
        return f"ColumnBatch(cap={self.capacity}, cols=[{cols}])"


def align_capacity(n: int, align: int) -> int:
    """Round n up to a multiple of `align` (min 1 unit)."""
    if n <= 0:
        return align
    return ((n + align - 1) // align) * align
