"""Derived tables — ``FROM (SELECT ...) alias``, CTEs and views.

Counterpart of ``harkdb_tpu.plan.derived``. A derived table
is an inner plan (a ``QueryPlan``, or a ``UnionPlan`` for a set-operation
body) wrapped in a Table-compatible source: the OUTER plan resolves names
against the inner plan's output schema at plan time, and the inner result
materializes lazily at first execution (cached on the plan — tables are
immutable while a plan is cached, the same contract subqueries rely on).
String outputs carry their dictionaries through, so LIKE / comparisons /
joins on derived string columns work unchanged.

On a mesh the inner query runs over the mesh (``DistExecutor``, or
``UnionPlan.execute(mesh=...)`` for a set operation); every rank receives
the whole result, keeps the same host copy and shards it again for the
outer plan (``sharded``).

Limits, as in the JAX package: the dense GROUP BY gate stays off for
derived columns (no host stats), and hidden LEFT-JOIN NULL flags do not
propagate OUT of a derived table (unmatched rows surface as the 0-fill).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.utils.metrics import host_read, span


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
        self._host: Optional[Tuple[Dict[str, np.ndarray], int]] = None
        self._shards: Dict[str, object] = {}   # per outer binding (a CTE
        #                                        source may back several)

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
        indicators dropped)."""
        if self._batch is None:
            with span("hark.subquery"):
                b = self.plan.execute(tables)
            outs = self._out_internal(b)
            self._batch = ColumnBatch(
                {nm: b.columns[oi] for nm, oi in zip(self._schema, outs)},
                b.n_valid,
            )
        return self._batch

    def materialize_host(self, tables, mesh=None, config=None,
                         shard_cache=None):
        """(host column dict, n_rows) of the inner result for sharding:
        the inner query runs over ``mesh`` when one of several ranks is
        given, and every rank gets the same copy."""
        if self._host is None:
            from harkdb_tpu_torch.plan.union_plan import UnionPlan

            if isinstance(self.plan, UnionPlan):
                # a set operation drives its own arms (distributed or not)
                b = self.plan.execute(tables, mesh=mesh,
                                      shard_cache=shard_cache)
            elif mesh is not None and mesh.size > 1:
                from harkdb_tpu_torch.parallel.executor import DistExecutor

                b = DistExecutor(self.plan, mesh, config,
                                 shard_cache=shard_cache).execute(tables)
            else:
                b = self.plan.execute(tables)
            with host_read("subquery"):
                n = int(b.n_valid)
                self._host = ({nm: b.columns[oi][:n].cpu().numpy()
                               for nm, oi in zip(self._schema,
                                                 self._out_internal(b))}, n)
        return self._host

    def sharded(self, tables, mesh, config, shard_cache, binding: str,
                remaps: Dict[str, np.ndarray]):
        """This rank's block of the inner result, cached here per outer
        binding (not in the Context's shard cache, which is keyed by table
        name: two plans may give different inner queries one alias).
        ``remaps`` are the outer plan's merged-dictionary code LUTs,
        applied on the host as for base tables."""
        if binding not in self._shards:
            from harkdb_tpu_torch.parallel.sharded import shard_batch

            host, n = self.materialize_host(tables, mesh, config,
                                            shard_cache)
            cols = {}
            for c, a in host.items():
                internal = f"{binding}.{c}"
                lut = remaps.get(internal)
                cols[internal] = lut[a] if lut is not None else a
            cols[f"#rid.{binding}"] = np.arange(n, dtype=np.int32)
            self._shards[binding] = shard_batch(cols, n, mesh, config)
        return self._shards[binding]
