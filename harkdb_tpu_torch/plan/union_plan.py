"""UNION / UNION ALL / INTERSECT / EXCEPT — counterpart of
``harkdb_tpu.plan.union_plan``.

Each arm plans independently (the full planner: pushdown, dense GROUP BY
gate, string lowering); the set operation itself is a small eager tail
over the arms' packed results — concatenate live rows, dedupe at every
non-ALL junction (left-associative, standard SQL), then the trailing
ORDER BY / OFFSET / LIMIT over the combined rows. String outputs merge
their dictionaries position-wise (codes remap through host LUTs so the
merged column stays lexicographically ordered).

Sorts are ``lexsort_permutation`` plus gathers; every pack is
``compact_batch`` (kernel A on a card); the run totals of INTERSECT /
EXCEPT use ``prims.scan`` (kernel B on a card).

On a mesh the mesh runner decides how a set operation runs: UNION /
UNION ALL as a sharded tail of its own, which reads the merged
dictionaries' code remaps, the float target and its span check from here;
INTERSECT / EXCEPT, and any set operation without ``dist_tail``, through
:meth:`UnionPlan.execute` with an ``execute`` that delivers each arm whole
to every rank, where every rank runs the same small combine.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch, align_capacity
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.ops.sort import lexsort_permutation, sort_batch
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.plan.nulls import null_extreme_sub
from harkdb_tpu_torch.plan.planner import QueryPlan
from harkdb_tpu_torch.prims.compaction import compact_batch
from harkdb_tpu_torch.prims.scan import running_max, running_min
from harkdb_tpu_torch.sql.ast_nodes import Col, Lit
from harkdb_tpu_torch.utils.metrics import count_setop, host_read, span


#: explicit mantissa bits per float type (numpy's ``finfo.nmant``)
_MANTISSA_BITS = {torch.float16: 10, torch.bfloat16: 7, torch.float32: 23,
                  torch.float64: 52}


def _first_of_runs(sorted_cols: List[torch.Tensor]) -> torch.Tensor:
    """True where a row of the sorted tuple differs from its predecessor
    (and on row 0): the first row of each run of equal tuples."""
    n = sorted_cols[0].shape[0]
    changed = torch.zeros(n, dtype=torch.bool, device=sorted_cols[0].device)
    for c in sorted_cols:
        changed = changed | (c != torch.cat([c[:1], c[:-1]]))
    changed[0] = True
    return changed


class UnionPlan:
    """Set operations over SELECT arms."""

    def __init__(self, stmt, tables: Dict[str, Table],
                 config: EngineConfig = DEFAULT_CONFIG):
        self.stmt = stmt
        self.config = config
        self.arms = [QueryPlan(arm, tables, config) for arm in stmt.arms]
        n_out = len(self.arms[0].output_names)
        for p in self.arms[1:]:
            if len(p.output_names) != n_out:
                raise PlanError(
                    "UNION arms must select the same number of columns"
                )
        self.output_names = list(self.arms[0].output_names)
        self.ops = list(stmt.ops)
        self.limit = stmt.limit
        self.offset = stmt.offset

        # Position-wise string dictionary merge across arms.
        self.output_dicts = []
        self.code_remaps = []        # per position: per-arm LUT or None
        for j in range(n_out):
            ds = [p.output_dicts[j] for p in self.arms]
            if all(d is None for d in ds):
                self.output_dicts.append(None)
                self.code_remaps.append(None)
                continue
            if any(d is None for d in ds):
                raise PlanError(
                    f"UNION arms mix string and numeric values in column "
                    f"{j + 1}"
                )
            merged = ds[0]
            for d in ds[1:]:
                merged = np.union1d(merged, d)
            self.output_dicts.append(merged)
            self.code_remaps.append([
                None if np.array_equal(d, merged)
                else np.searchsorted(merged, d).astype(np.int32)
                for d in ds
            ])

        # Trailing ORDER BY resolves against output names or 1-based
        # ordinals (the arms' internal columns are out of scope by then).
        # Entries: (output position, descending, nulls placement).
        self.order_pos: List[Tuple[int, bool, object]] = []
        for o in stmt.order_by:
            e = o.expr
            if (isinstance(e, Col) and e.table is None
                    and e.name in self.output_names):
                self.order_pos.append(
                    (self.output_names.index(e.name), o.descending, o.nulls)
                )
            elif (isinstance(e, Lit) and isinstance(e.value, int)
                    and 1 <= e.value <= n_out):
                self.order_pos.append((e.value - 1, o.descending, o.nulls))
            else:
                raise PlanError(
                    "UNION ORDER BY must reference an output column name "
                    "or a 1-based column position"
                )

    def _arm_cols(self, ai: int, batch: ColumnBatch):
        """Live-row column slices of one arm's result, codes remapped into
        the merged dictionaries, plus per-position NULL-indicator slices
        (None when the arm's output is never NULL). NULL cells are zeroed
        so every NULL normalizes to the same (0, flag=0) pair — set-op
        semantics treat NULLs as equal, whatever expression produced them."""
        with host_read("union"):
            n = int(batch.n_valid)
        count_setop(n)
        cols, flags = [], []
        outs = [nm for nm in batch.names if not nm.startswith("#nullflag")]
        for j, internal in enumerate(outs):
            col = batch.columns[internal][:n]
            remaps = self.code_remaps[j]
            if remaps is not None and remaps[ai] is not None:
                with host_read("upload"):
                    lut = torch.as_tensor(remaps[ai]).to(col.device)
                col = lut[col.long()]
            fl = batch.columns.get(f"#nullflag{j}")
            if fl is not None:
                fl = (fl[:n] != 0).to(torch.int32)
                col = torch.where(fl != 0, col, torch.zeros_like(col))
            cols.append(col)
            flags.append(fl)
        return cols, flags

    def _pack(self, cols: List[torch.Tensor],
              keep: torch.Tensor) -> List[torch.Tensor]:
        """The rows of ``cols`` where ``keep`` holds, packed (kernel A on
        a card); one readback of the count."""
        n = cols[0].shape[0]
        b = compact_batch(
            ColumnBatch(
                {f"#u{j}": c for j, c in enumerate(cols)},
                torch.full((), n, dtype=torch.int32, device=cols[0].device),
            ),
            keep,
        )
        with host_read("union"):
            k = int(b.n_valid)
        return [b.columns[f"#u{j}"][:k] for j in range(len(cols))]

    def _dedupe(self, cols: List[torch.Tensor], nf: int) -> List[torch.Tensor]:
        """Distinct rows of a packed (no padding) column tuple. The last
        ``nf`` entries are NULL-indicator columns: they participate as keys
        (value 0 with flag 0 = the one canonical NULL row ≠ a real 0), and
        NULLs compare EQUAL to each other — SQL set-op semantics."""
        n = cols[0].shape[0]
        if n == 0:
            return cols
        perm = lexsort_permutation(cols)
        sorted_cols = [c[perm] for c in cols]
        return self._pack(sorted_cols, _first_of_runs(sorted_cols))

    def _set_combine(self, cols: List[torch.Tensor], tag: torch.Tensor,
                     op: str) -> List[torch.Tensor]:
        """INTERSECT / EXCEPT (distinct) of packed column tuples: rows with
        ``tag`` 0 come from the accumulated left side, 1 from the new arm.
        One sort by (tuple..., tag) groups equal tuples into runs with the
        left copies first; per-run tag counts (running max / reversed
        running min fills — scatter-free) decide membership, and the first
        row of each qualifying run survives. NULL indicators ride as
        ordinary key columns (NULL cells are zero-normalized), so NULLs
        compare EQUAL — SQL set-op semantics."""
        n = cols[0].shape[0]
        if n == 0:
            return cols
        perm = lexsort_permutation(cols + [tag])
        scols = [c[perm] for c in cols]
        stag = tag[perm]
        start = _first_of_runs(scols)
        dev = stag.device
        big = torch.full((), n + 1, dtype=torch.int32, device=dev)

        def run_totals(x):
            """Per-row total of x over the row's equal-tuple run."""
            cum = torch.cumsum(x, 0, dtype=torch.int32)
            excl = cum - x
            base = running_max(torch.where(start, excl, 0))
            aoa = running_min(torch.where(start, excl, big), reverse=True)
            nxt = torch.minimum(torch.cat([aoa[1:], big[None]]), cum[-1])
            return nxt - base

        ones_in = run_totals(stag.to(torch.int32))
        size_in = run_totals(torch.ones(n, dtype=torch.int32, device=dev))
        zeros_in = size_in - ones_in
        if op == "intersect":
            keep = start & (ones_in > 0) & (zeros_in > 0)
        else:                                            # except
            keep = start & (ones_in == 0) & (zeros_in > 0)
        return self._pack(scols, keep)

    def execute(self, tables: Dict[str, Table],
                execute=None) -> ColumnBatch:
        """Run every arm (through ``execute(plan)`` when given: the mesh
        runner delivers each arm whole to every rank, so the combine reads
        the same values, and takes the same branches, on every rank) and
        combine them. The combination runs inside ``hark.setop``, the
        arms' plans outside it."""
        acc: List[torch.Tensor] = []
        acc_flags: List[object] = [None] * len(self.output_names)
        for ai, p in enumerate(self.arms):
            batch = p.execute(tables) if execute is None else execute(p)
            with span("hark.setop"):
                cols, flags = self._arm_cols(ai, batch)
                if ai == 0:
                    acc, acc_flags = cols, flags
                else:
                    acc, acc_flags = self._combine(acc, acc_flags, cols,
                                                   flags, self.ops[ai - 1])
        with span("hark.setop"):
            return self._finish(acc, acc_flags)

    def _combine(self, acc, acc_flags, cols, flags, op: str):
        """The accumulated arms' rows and NULL indicators set-combined with
        the next arm's by ``op``."""
        n_out = len(self.output_names)
        merged = []
        for a, c in zip(acc, cols):
            if a.dtype.is_floating_point != c.dtype.is_floating_point:
                tgt = self.float_target()
                # Integers beyond the float target's exact-integer span
                # would silently lose precision in the cast — corrupting
                # values AND making distinct-dedupe merge unequal rows.
                # The tail is eager, so a range readback is cheap.
                for x in (a, c):
                    if not x.dtype.is_floating_point and x.shape[0]:
                        with host_read("union"):
                            lo, hi = int(x.min()), int(x.max())
                        self.check_span(max(abs(lo), abs(hi)))
                a, c = a.to(tgt), c.to(tgt)
            merged.append(torch.cat([a, c]))
        # NULL indicators concatenate alongside (missing side = all-1)
        na, nc = acc[0].shape[0], cols[0].shape[0]
        dev = acc[0].device
        mflags = []
        for fa, fc in zip(acc_flags, flags):
            if fa is None and fc is None:
                mflags.append(None)
                continue
            fa = fa if fa is not None else torch.ones(
                na, dtype=torch.int32, device=dev)
            fc = fc if fc is not None else torch.ones(
                nc, dtype=torch.int32, device=dev)
            mflags.append(torch.cat([fa, fc]))
        acc, acc_flags = merged, mflags
        if op != "union all":
            nf_idx = [j for j, f in enumerate(acc_flags) if f is not None]
            packed = acc + [acc_flags[j] for j in nf_idx]
            if op == "union":
                dd = self._dedupe(packed, len(nf_idx))
            else:                       # intersect / except
                tag = torch.cat([
                    torch.zeros(na, dtype=torch.int32, device=dev),
                    torch.ones(nc, dtype=torch.int32, device=dev),
                ])
                dd = self._set_combine(packed, tag, op)
            acc = dd[:n_out]
            acc_flags = list(acc_flags)
            for k, j in enumerate(nf_idx):
                acc_flags[j] = dd[n_out + k]
        return acc, acc_flags

    def _finish(self, acc, acc_flags) -> ColumnBatch:
        """The combined rows as a batch, in the trailing ORDER BY's order,
        OFFSET and LIMIT applied."""
        total = int(acc[0].shape[0]) if acc else 0
        cap = align_capacity(total, self.config.row_align)
        dev = acc[0].device

        def padded(c, fill=0):
            pad = cap - c.shape[0]
            if pad:
                c = torch.cat([c, torch.full((pad,), fill, dtype=c.dtype,
                                             device=dev)])
            return c

        out_cols = {}
        for j, c in enumerate(acc):
            out_cols[f"#out{j}"] = padded(c)
        for j, f in enumerate(acc_flags):
            if f is not None:
                out_cols[f"#nullflag{j}"] = padded(f, 1)
        out = ColumnBatch(out_cols, torch.full((), total, dtype=torch.int32,
                                               device=dev))

        if self.order_pos:
            key_arrays = []
            for j, d, nu in self.order_pos:
                a = out.columns[f"#out{j}"]
                f = out.columns.get(f"#nullflag{j}")
                if f is not None:
                    a = null_extreme_sub(a, f == 0, d, nu)
                key_arrays.append(a)
            out = sort_batch(
                out, [],
                [d for _j, d, _nu in self.order_pos],
                key_arrays=key_arrays,
            )
        if self.offset:
            idx = torch.arange(out.capacity, dtype=torch.int32, device=dev)
            out = compact_batch(out, idx >= self.offset)
        if self.limit is not None:
            out = ColumnBatch(
                out.columns, torch.clamp(out.n_valid, max=self.limit)
            )
        return out

    def float_target(self) -> torch.dtype:
        return getattr(torch, self.config.float_dtype)

    def check_span(self, max_abs: int) -> None:
        """Raise when an integer of ``max_abs`` would not survive the cast
        to the float target (int and float arms merged in one column)."""
        span = 1 << (_MANTISSA_BITS[self.float_target()] + 1)
        if max_abs > span:
            raise PlanError(
                f"UNION mixes int and float values in a column and an "
                f"integer exceeds {self.config.float_dtype}'s exact-integer "
                f"span (±{span}); the cast would corrupt it"
            )

    def explain(self) -> str:
        lines = []
        for i, p in enumerate(self.arms):
            if i:
                lines.append({
                    "union all": "Union All",
                    "union": "Union (distinct)",
                    "intersect": "Intersect (distinct)",
                    "except": "Except (distinct)",
                }[self.ops[i - 1]])
            lines.extend("  " + ln for ln in p.explain().splitlines())
        if self.order_pos:
            lines.append("Sort " + ", ".join(
                ("DESC" if d else "ASC") for _j, d, _nu in self.order_pos
            ))
        if self.offset:
            lines.append(f"Offset {self.offset}")
        if self.limit is not None:
            lines.append(f"Limit {self.limit}")
        return "\n".join(lines)
