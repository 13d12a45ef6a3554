"""Derived tables — ``FROM (SELECT ...) alias``, CTEs and views.

Counterpart of ``harkdb_tpu.plan.derived`` on one device. A derived table
is an inner plan (a ``QueryPlan``, or a ``UnionPlan`` for a set-operation
body) wrapped in a Table-compatible source: the OUTER plan resolves names
against the inner plan's output schema at plan time, and the inner result
materializes lazily at first execution (cached on the plan — tables are
immutable while a plan is cached, the same contract subqueries rely on).
String outputs carry their dictionaries through, so LIKE / comparisons /
joins on derived string columns work unchanged.

Limits, as in the JAX package: the dense GROUP BY gate stays off for
derived columns (no host stats), and hidden LEFT-JOIN NULL flags do not
propagate OUT of a derived table (unmatched rows surface as the 0-fill).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.plan.errors import PlanError


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
        self._batch: Optional[ColumnBatch] = None

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
    def batch(self, tables) -> ColumnBatch:
        """The inner result, columns renamed to the schema (hidden NULL
        indicators dropped)."""
        if self._batch is None:
            b = self.plan.execute(tables)
            outs = [n for n in b.names if not n.startswith("#nullflag")]
            self._batch = ColumnBatch(
                {nm: b.columns[oi] for nm, oi in zip(self._schema, outs)},
                b.n_valid,
            )
        return self._batch
