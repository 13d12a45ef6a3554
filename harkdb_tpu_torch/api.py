"""Context — the BlazingSQL-style public API (reference FutharkContext.py:38-71).

Counterpart of ``harkdb_tpu.api`` on one device chosen explicitly:

  * ``create_table(name, source)`` / ``drop_table(name)``
  * ``sql(statement)`` → numpy 2-D matrix (the reference's output shape,
    FutharkContext.py:66,71); ``sql_df`` → pandas DataFrame; ``sql_batch``
    → the device-resident result batch
  * ``explain``, views (``create_view`` / ``drop_view``), ``save`` / ``load``
    (the JAX package's checkpoint format: npz files + ``manifest.json``)
  * ``profile`` → ``sql``'s matrix, with a ``torch.profiler`` trace

Plans are cached on the Context keyed by (sql text, table signature), the
``PLAN_CACHE_ENTRIES`` most recently used. A plan keeps its parse, binding
and lowering, never a result: subqueries and derived tables run on every
execution, and what they made is dropped when the query returns.
Under a mesh (``Context(mesh=...)``) every rank runs the same calls and
queries run through ``parallel/executor.run_on_mesh``.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.columnar.device import resolve_device
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.utils.metrics import (
    QueryMetrics, StageTimer, host_read, inner_plans_run, joins_counted,
    rows_counted, sorts_counted, span,
)

#: Plans a Context keeps, the least recently used dropped first: a bound on
#: host memory when every query brings new literals.
PLAN_CACHE_ENTRIES = 256


class Context:
    def __init__(self, config: EngineConfig = DEFAULT_CONFIG,
                 device=None, mesh=None):
        """``device``: where tables live and queries run — ``"cuda"``
        (the default; raises when no CUDA device is available) or
        ``"cpu"``. CUDA tensors go through the hand-written kernels, CPU
        tensors through their plain PyTorch versions.

        ``mesh``: an :class:`~harkdb_tpu_torch.parallel.mesh.EngineMesh`
        (``parallel.make_engine_mesh``), one per rank of a process group.
        Every rank then makes the same calls with the same tables: each
        keeps its chunk of every table on ``mesh.device`` (the default
        ``device``), queries run distributed, and every rank returns the
        whole result. A mesh of one rank runs the single-device path."""
        if mesh is not None:
            d = torch.device(mesh.device if device is None else device)
            if d.type != mesh.device.type or d.index not in (
                    None, mesh.device.index):
                raise ValueError(f"device {device} differs from the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        device = resolve_device(device, "Context")
        self.config = config
        self.device = device
        self.mesh = mesh
        self.tables: Dict[str, Table] = {}
        # card bytes each table took, as the allocator counts them
        self._table_bytes: Dict[str, int] = {}
        self.views: Dict[str, str] = {}
        self._plan_cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._shard_cache: Dict[tuple, object] = {}
        self.last_metrics = None

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    # -- tables (reference surface) -------------------------------------------
    def create_table(self, table_name: str, source, col_names=None) -> None:
        # Under a mesh of several ranks the Table keeps host copies only
        # (its tensors on the CPU); each rank's chunk goes to mesh.device
        # when a query first reads it (parallel/executor.py's shard cache).
        before = self._allocated()
        table = Table(
            table_name, source, self.config, col_names=col_names,
            device="cpu" if self.distributed else self.device,
        )
        self._table_bytes[table_name] = self._allocated() - before
        self.tables[table_name] = table
        self._forget(table_name)

    def drop_table(self, table_name: str) -> None:
        del self.tables[table_name]
        self._table_bytes.pop(table_name, None)
        self._forget(table_name)

    def _forget(self, table_name: str) -> None:
        self._plan_cache.clear()
        self._shard_cache = {k: v for k, v in self._shard_cache.items()
                             if k[0] != table_name}

    # -- views (engine extension: persistent CTEs) -----------------------------
    def create_view(self, name: str, sql_statement: str) -> None:
        """Register a named SELECT as a view. Views substitute at parse
        time exactly like CTEs (``WITH name AS (...)``): querying one plans
        the body as a derived table with one materialization per query."""
        if name in self.tables:
            raise ValueError(f"{name!r} is already a table")
        from harkdb_tpu_torch.sql.parser import parse_sql

        parse_sql(sql_statement, views=self.views)   # syntax-check now
        self.views[name] = sql_statement
        self._plan_cache.clear()

    def drop_view(self, name: str) -> None:
        del self.views[name]
        self._plan_cache.clear()

    # -- queries --------------------------------------------------------------
    def _plan(self, sql_statement: str):
        from harkdb_tpu_torch.plan.planner import plan_query

        key = (sql_statement, self._table_signature())
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = plan_query(self.tables, sql_statement, self.config,
                              views=self.views)
            self._plan_cache[key] = plan
            if len(self._plan_cache) > PLAN_CACHE_ENTRIES:
                self._plan_cache.popitem(last=False)
        else:
            self._plan_cache.move_to_end(key)
        return plan

    def _table_signature(self) -> tuple:
        return tuple(
            (name, t.capacity, tuple(t.get_schema()),
             tuple(str(c.dtype) for c in t.columns.values()))
            for name, t in sorted(self.tables.items())
        ) + tuple(sorted(self.views.items()))

    def sql_batch(self, sql_statement: str) -> Tuple[ColumnBatch, List[str]]:
        """Run a query; return the device-resident result batch + headers."""
        out, m, _t0 = self._execute(sql_statement)
        m.held_bytes = self._held_bytes()
        m.log()
        return out, self._last_plan.output_names

    def _execute(self, sql_statement: str
                 ) -> Tuple[ColumnBatch, QueryMetrics, float]:
        """Plan (or find the cached plan) and run it: the result batch, the
        query's metrics (``plan_ms``; ``execute_ms`` to the plan's return)
        and ``time.perf_counter()`` at the plan's start. Reads nothing
        back beyond the plan's own host reads."""
        m = QueryMetrics(sql=sql_statement)
        key = (sql_statement, self._table_signature())
        m.cached_plan = key in self._plan_cache
        with StageTimer("hark.plan") as t:
            plan = self._plan(sql_statement)
        m.plan_ms = t.ms
        m.distributed = self.distributed
        inner0, sorts0 = inner_plans_run(), sorts_counted()
        joins0, rows0 = joins_counted(), rows_counted()
        t0 = time.perf_counter()
        if self.distributed:
            # No retry: one rank retrying alone would enter collectives
            # the others have left.
            out = self._execute_distributed(plan)
        else:
            try:
                out = plan.execute(self.tables)
            except (RuntimeError, OSError):
                # Queries are pure over resident tables — one
                # re-execution covers a transient device failure.
                if not self.config.retry_on_failure:
                    raise
                out = plan.execute(self.tables)
        m.execute_ms = (time.perf_counter() - t0) * 1e3
        m.inner_plans_run = inner_plans_run() - inner0
        m.sort_rows, m.sort_row_bits = (
            a - b for a, b in zip(sorts_counted(), sorts0))
        m.join_rows, m.join_fused_rows = (
            a - b for a, b in zip(joins_counted(), joins0))
        m.window_rows, m.setop_rows = (
            a - b for a, b in zip(rows_counted(), rows0))
        self.last_metrics = m
        self._last_plan = plan          # sql_df reads output_dicts from here
        return out, m, t0

    def _returned(self, m: QueryMetrics, t0: float, rows: int) -> None:
        """Complete ``m`` once the result is on the host: ``execute_ms``
        from the plan's start (``t0``), ``rows_out`` from the host result."""
        m.execute_ms = (time.perf_counter() - t0) * 1e3
        if self.config.collect_metrics:
            m.rows_out = rows
        m.held_bytes = self._held_bytes()
        m.log()

    def _allocated(self) -> int:
        """``torch.cuda.memory_allocated`` of the Context's card (0 off
        it): an allocator statistic read on the host, no sync (read from
        the nested statistics, which ``memory_allocated`` would flatten
        and sort first)."""
        if self.device.type != "cuda" or not torch.cuda.is_initialized():
            return 0
        stats = torch.cuda.memory_stats_as_nested_dict(self.device)
        return stats["allocated_bytes"]["all"]["current"]

    def _held_bytes(self) -> int:
        """Card memory allocated less the resident tables (as
        ``create_table`` found them, and on a mesh their cached shards):
        what queries left on the card. -1 off the card."""
        if self.device.type != "cuda":
            return -1
        shards = sum(c.numel() * c.element_size()
                     for sb in self._shard_cache.values()
                     for c in (*sb.columns.values(), sb.count))
        return self._allocated() - sum(self._table_bytes.values()) - shards

    def _execute_distributed(self, plan) -> ColumnBatch:
        from harkdb_tpu_torch.parallel.executor import run_on_mesh

        return run_on_mesh(plan, self.tables, self.mesh, self.config,
                           self._shard_cache)

    # -- persistence (SURVEY §5 checkpoint slot) ------------------------------
    def save(self, directory: str) -> None:
        """Persist every registered table as an npz checkpoint."""
        from harkdb_tpu_torch.utils.persist import save_tables

        save_tables(self.tables, directory)

    def load(self, directory: str) -> None:
        """Re-register tables previously saved with :meth:`save` (by this
        package or by ``harkdb_tpu``: the format is shared)."""
        from harkdb_tpu_torch.utils.persist import load_tables

        load_tables(self, directory)

    def sql(self, sql_statement: str) -> np.ndarray:
        """Run a query, returning a dense row-major numpy matrix (reference
        output shape, ``FutharkContext.py:66,71``). Hidden NULL-indicator
        columns are dropped — the raw matrix shows the 0-fill; use
        :meth:`sql_df` for None/NaN decoding."""
        batch, m, t0 = self._execute(sql_statement)
        with span("hark.result"):
            keep = [n for n in batch.names if not n.startswith("#nullflag")]
            out = batch.select(keep).to_numpy()[0]
        del batch                       # held_bytes counts what remains
        self._returned(m, t0, out.shape[0])
        return out

    def sql_df(self, sql_statement: str):
        """Run a query, returning a pandas DataFrame with output headers.

        String outputs (dictionary-encoded columns, or MIN/MAX over them)
        decode host-side here — the device result holds int32 codes; ``sql``
        returns the raw code matrix. NULL outputs decode to None (strings) /
        NaN (numeric) through the hidden per-output NULL-indicator columns."""
        import pandas as pd

        batch, m, t0 = self._execute(sql_statement)
        names = self._last_plan.output_names
        dicts = getattr(self._last_plan, "output_dicts", None) or [None] * len(
            names
        )
        out_internal = [
            nm for nm in batch.names if not nm.startswith("#nullflag")
        ]
        data = {}
        with span("hark.result"):
            with host_read("result"):
                n = int(batch.n_valid)
            for j, ((display, internal), d) in enumerate(zip(
                zip(names, out_internal), dicts
            )):
                with host_read("result"):
                    col = batch.columns[internal][:n].cpu().numpy()
                flag = batch.columns.get(f"#nullflag{j}")
                nulls = None
                if flag is not None:
                    with host_read("result"):
                        nulls = flag[:n].cpu().numpy() == 0
                    if not nulls.any():
                        nulls = None
                if d is not None:
                    col = d[np.clip(col, 0, len(d) - 1)]
                    if nulls is not None:
                        col = col.astype(object)
                        col[nulls] = None
                elif nulls is not None:
                    col = col.astype(np.float64)
                    col[nulls] = np.nan
                # duplicate display names get pandas-style disambiguation
                key = display
                i = 1
                while key in data:
                    key = f"{display}.{i}"
                    i += 1
                data[key] = col
            frame = pd.DataFrame(data)
        batch = flag = None             # held_bytes counts what remains
        self._returned(m, t0, n)
        return frame

    def explain(self, sql_statement: str) -> str:
        return self._plan(sql_statement).explain()

    def profile(self, sql_statement: str,
                trace_dir: Optional[str] = None) -> np.ndarray:
        """Run a query under ``torch.profiler`` and return :meth:`sql`'s
        matrix.

        Records the host's activity, and the card's kernels when the
        Context runs on CUDA, and writes one Chrome trace file
        (``harkdb_<pid>_<ns>.json``; open it in Perfetto or
        ``chrome://tracing``) into ``trace_dir``, created if missing
        (default: ``harkdb_trace`` in the temporary directory).
        """
        from torch.profiler import ProfilerActivity, profile

        if trace_dir is None:
            trace_dir = os.path.join(tempfile.gettempdir(), "harkdb_trace")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            out = self.sql(sql_statement)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"harkdb_{os.getpid()}_{time.time_ns()}.json"))
        return out
