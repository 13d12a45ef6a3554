"""Derived tables — ``FROM (SELECT ...) alias``, CTEs and views.

Counterpart of ``harkdb_tpu.plan.derived``. A derived table
is an inner plan (a ``QueryPlan``, or a ``UnionPlan`` for a set-operation
body) wrapped in a Table-compatible source: the OUTER plan resolves names
against the inner plan's output schema at plan time, and the inner result
materializes lazily, on first use within each execution of the outer plan,
which drops it when it returns (``release``): a cached plan keeps its
plan, never a result. String outputs carry their dictionaries through, so
LIKE / comparisons / joins on derived string columns work unchanged.

On a mesh the mesh runner runs the inner query (``materialize_host``):
every rank receives the whole result and keeps the same host copy for
that execution, which the outer plan's executor shards again.

Limits, as in the JAX package: the dense GROUP BY gate stays off for
derived columns (no host stats), and hidden LEFT-JOIN NULL flags do not
propagate OUT of a derived table (unmatched rows surface as the 0-fill).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.utils.metrics import host_read, inner_plan


class DerivedSource:
    """Table-surface adapter over an inner plan (the subset the planner
    touches)."""

    #: planner stat probes (dense-path gates, dtype sniffing) see no host
    #: columns and correctly fall back to the general paths.
    host_columns: Dict[str, np.ndarray] = {}

    def __init__(self, plan):
        self.plan = plan
        names = list(plan.output_names)
        if len(set(names)) != len(names):
            raise PlanError(
                "Derived table output column names must be unique; "
                "alias duplicated expressions"
            )
        self._schema = names
        # This execution's materialization (``release`` drops it).
        self._batch: Optional[ColumnBatch] = None
        self._host: Optional[Tuple[Dict[str, np.ndarray], int]] = None

    def release(self) -> None:
        """Drop the materialization: the outer plan's execution ends."""
        self._batch = None
        self._host = None

    # -- planner surface ------------------------------------------------------
    def get_schema(self) -> List[str]:
        return list(self._schema)

    def column_dict(self, name: str):
        try:
            i = self._schema.index(name)
        except ValueError:
            return None
        return self.plan.output_dicts[i]

    def column_range(self, _name: str):
        return None                     # no host stats → no dense path

    # -- materialization ------------------------------------------------------
    @staticmethod
    def _out_internal(b: ColumnBatch) -> List[str]:
        return [n for n in b.names if not n.startswith("#nullflag")]

    def batch(self, tables) -> ColumnBatch:
        """The inner result, columns renamed to the schema (hidden NULL
        indicators dropped); run on first use within an execution."""
        if self._batch is None:
            with inner_plan():
                b = self.plan.execute(tables)
            outs = self._out_internal(b)
            self._batch = ColumnBatch(
                {nm: b.columns[oi] for nm, oi in zip(self._schema, outs)},
                b.n_valid,
            )
        return self._batch

    def materialize_host(self, tables, execute):
        """(host column dict, n_rows) of the inner result, run on first use
        within an execution through ``execute(plan)`` (the mesh runner:
        every rank gets the whole result, and so the same copy)."""
        if self._host is None:
            with inner_plan():
                b = execute(self.plan)
            with host_read("subquery"):
                n = int(b.n_valid)
                self._host = ({nm: b.columns[oi][:n].cpu().numpy()
                               for nm, oi in zip(self._schema,
                                                 self._out_internal(b))}, n)
        return self._host
