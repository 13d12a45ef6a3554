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

On a mesh of several ranks, UNION / UNION ALL run as a sharded tail
(:meth:`UnionPlan._execute_sharded`): each rank keeps about 1/D of the
combined rows until the one delivery. INTERSECT / EXCEPT and
``dist_tail=False`` run each arm over the mesh, deliver it to every rank
and combine it there, the same small combine on every rank.
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
from harkdb_tpu_torch.plan.planner import QueryPlan, _null_extreme_sub
from harkdb_tpu_torch.prims.compaction import compact_batch
from harkdb_tpu_torch.prims.scan import running_max, running_min
from harkdb_tpu_torch.sql.ast_nodes import Col, Lit


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
        self._code_remaps = []       # per position: per-arm LUT or None
        for j in range(n_out):
            ds = [p.output_dicts[j] for p in self.arms]
            if all(d is None for d in ds):
                self.output_dicts.append(None)
                self._code_remaps.append(None)
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
            self._code_remaps.append([
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
        n = int(batch.n_valid)
        cols, flags = [], []
        outs = [nm for nm in batch.names if not nm.startswith("#nullflag")]
        for j, internal in enumerate(outs):
            col = batch.columns[internal][:n]
            remaps = self._code_remaps[j]
            if remaps is not None and remaps[ai] is not None:
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

    def execute(self, tables: Dict[str, Table], mesh=None,
                shard_cache=None) -> ColumnBatch:
        cfg = self.config
        distributed = mesh is not None and mesh.size > 1
        if (distributed and cfg.dist_tail
                and all(op in ("union", "union all") for op in self.ops)):
            return self._execute_sharded(tables, mesh, shard_cache)

        def run_arm(p: QueryPlan) -> ColumnBatch:
            if distributed:
                from harkdb_tpu_torch.parallel.executor import DistExecutor

                # every rank receives the whole arm, so the combine below
                # reads the same values, and takes the same branches, on
                # every rank
                return DistExecutor(p, mesh, cfg,
                                    shard_cache=shard_cache).execute(tables)
            return p.execute(tables)

        n_out = len(self.output_names)
        acc: List[torch.Tensor] = []
        acc_flags: List[object] = [None] * n_out
        for ai, p in enumerate(self.arms):
            cols, flags = self._arm_cols(ai, run_arm(p))
            if ai == 0:
                acc, acc_flags = cols, flags
                continue
            merged = []
            for a, c in zip(acc, cols):
                if a.dtype.is_floating_point != c.dtype.is_floating_point:
                    tgt = self._float_target()
                    # Integers beyond the float target's exact-integer span
                    # would silently lose precision in the cast — corrupting
                    # values AND making distinct-dedupe merge unequal rows.
                    # The tail is eager, so a range readback is cheap.
                    for x in (a, c):
                        if not x.dtype.is_floating_point and x.shape[0]:
                            self._check_span(max(abs(int(x.min())),
                                                 abs(int(x.max()))))
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
            op = self.ops[ai - 1]
            if op != "union all":
                nf_idx = [j for j, f in enumerate(acc_flags)
                          if f is not None]
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

        total = int(acc[0].shape[0]) if acc else 0
        cap = align_capacity(total, cfg.row_align)
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
                    a = _null_extreme_sub(a, f == 0, d, nu)
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

    def _float_target(self) -> torch.dtype:
        return getattr(torch, self.config.float_dtype)

    def _check_span(self, max_abs: int) -> None:
        """Raise when an integer of ``max_abs`` would not survive the cast
        to the float target (int and float arms merged in one column)."""
        span = 1 << (_MANTISSA_BITS[self._float_target()] + 1)
        if max_abs > span:
            raise PlanError(
                f"UNION mixes int and float values in a column and an "
                f"integer exceeds {self.config.float_dtype}'s exact-integer "
                f"span (±{span}); the cast would corrupt it"
            )

    def _execute_sharded(self, tables: Dict[str, Table], mesh,
                         shard_cache) -> ColumnBatch:
        """The UNION tail on a mesh, sharded: arms run to their ranks'
        projected blocks (``DistExecutor.execute(deliver=False)``) and are
        concatenated rank by rank; a non-ALL junction dedupes through the
        tuple-hash ``dist_groupby``; the trailing ORDER BY / OFFSET / LIMIT
        are ``dist_orderby`` / ``dist_head``; one delivery at the end. Each
        rank holds about 1/D of the combined rows until then
        (``last_tail_capacities`` records (stage, this rank's capacity)).

        Order parity with the single-device tail: a hidden ``#upos``
        column holds each row's position in the arms' concatenation
        (after a dedupe, which leaves the single device's rows sorted by
        tuple, the tuple's rank); the final sort's key chain is (ORDER BY
        outputs, ``#upos``)."""
        from harkdb_tpu_torch.parallel.dist_ops import (
            dist_filter, dist_groupby, dist_head, dist_map, dist_orderby,
            shrink_sharded,
        )
        from harkdb_tpu_torch.parallel.executor import DistExecutor
        from harkdb_tpu_torch.parallel.sharded import ShardedBatch

        cfg = self.config
        n_out = len(self.output_names)
        out_names = [f"#out{j}" for j in range(n_out)]
        caps = []

        # Every arm runs sharded first, so the union-wide set of NULL
        # indicators is known before any arm is normalised to it.
        arm_sbs = [DistExecutor(p, mesh, cfg, shard_cache=shard_cache)
                   .execute(tables, deliver=False) for p in self.arms]
        nf_idx = sorted({j for sb in arm_sbs for j in range(n_out)
                         if f"#nullflag{j}" in sb.names})
        all_names = out_names + [f"#nullflag{j}" for j in nf_idx]

        def positions(sb: ShardedBatch, base: int):
            """``sb`` with ``#upos`` = base + the row's global live
            position (rank order), and the live rows over all ranks."""
            gc = mesh.all_gather(sb.count.reshape(1)).reshape(-1)
            prefix = gc[:mesh.rank].sum(dtype=torch.int32)
            cols = dict(sb.columns)
            cols["#upos"] = base + prefix + torch.arange(
                sb.local_capacity, dtype=torch.int32, device=prefix.device)
            return ShardedBatch(cols, sb.count), int(gc.sum())

        def concat(a: ShardedBatch, b: ShardedBatch) -> ShardedBatch:
            """Rank-wise concatenation, live rows packed first (a's, then
            b's: kernel A over the joined blocks)."""
            dev = a.count.device
            live = torch.cat([
                torch.arange(a.local_capacity, device=dev) < a.count,
                torch.arange(b.local_capacity, device=dev) < b.count])
            both = ShardedBatch(
                {n: torch.cat([a.columns[n], b.columns[n]])
                 for n in a.names},
                torch.full((), live.shape[0], dtype=torch.int32, device=dev))
            return dist_filter(both, lambda cols, cap: live)

        def dedupe(sb: ShardedBatch):
            """Distinct tuples in global tuple order, positions renewed
            (the single-device dedupe leaves rows sorted by (values,
            flags); NULL cells are zeroed, so NULLs dedupe as equal)."""
            sb = dist_groupby(ShardedBatch({n: sb.columns[n]
                                            for n in all_names}, sb.count),
                              all_names, [], mesh)
            sb = dist_orderby(sb, lambda cols, cap: [cols[n]
                                                     for n in all_names],
                              [False] * len(all_names), mesh)
            return positions(sb, 0)

        acc = None
        base = 0
        for ai, sb in enumerate(arm_sbs):
            caps.append((f"arm{ai}", sb.local_capacity))
            # Normalise to the union-wide columns: merged-dictionary code
            # remaps, all-1 flags where this arm has no indicator, NULL
            # cells zeroed (one canonical NULL per position).
            luts = {j: torch.as_tensor(self._code_remaps[j][ai]).to(
                        mesh.device)
                    for j in range(n_out)
                    if self._code_remaps[j] is not None
                    and self._code_remaps[j][ai] is not None}
            have = set(sb.names)

            def norm_fn(cols, cap, _luts=luts, _have=have):
                out = {}
                for j in range(n_out):
                    c = cols[f"#out{j}"]
                    lut = _luts.get(j)
                    if lut is not None:
                        c = lut[torch.clamp(c, 0, lut.shape[0] - 1).long()]
                    out[f"#out{j}"] = c
                for j in nf_idx:
                    fname = f"#nullflag{j}"
                    if fname in _have:
                        fl = (cols[fname] != 0).to(torch.int32)
                        out[fname] = fl
                        c = out[f"#out{j}"]
                        out[f"#out{j}"] = torch.where(fl != 0, c,
                                                      torch.zeros_like(c))
                    else:
                        out[fname] = torch.ones(cap, dtype=torch.int32,
                                                device=mesh.device)
                return out

            sb, n_arm = positions(dist_map(sb, norm_fn), base)
            base += n_arm
            if acc is None:
                acc = sb
                continue
            # int / float promotion, guarded by the exact-integer span read
            # from an all-reduced maximum (the same on every rank)
            casts = []
            for j in range(n_out):
                name = f"#out{j}"
                a_, c_ = acc.columns[name], sb.columns[name]
                if a_.dtype.is_floating_point == c_.dtype.is_floating_point:
                    continue
                for part in (acc, sb):
                    x = part.columns[name]
                    if not x.dtype.is_floating_point:
                        live = torch.arange(x.shape[0],
                                            device=x.device) < part.count
                        m = torch.where(live, x.to(torch.int64).abs(),
                                        0).max()
                        self._check_span(int(mesh.all_reduce(m.reshape(1),
                                                             "max")))
                casts.append(name)
            if casts:
                tgt = self._float_target()

                def cast_fn(cols, cap, _c=tuple(casts)):
                    return {n: c.to(tgt) if n in _c else c
                            for n, c in cols.items()}

                acc, sb = dist_map(acc, cast_fn), dist_map(sb, cast_fn)
            acc = shrink_sharded(concat(acc, sb), mesh)
            caps.append((f"concat{ai}", acc.local_capacity))
            if self.ops[ai - 1] == "union":
                acc, base = dedupe(acc)
                caps.append((f"dedupe{ai}", acc.local_capacity))

        # The final global order: the trailing ORDER BY's outputs (NULL
        # placement by the indicators), ties by #upos — the single-device
        # stable sort over the concatenation / dedupe order.
        order_pos = list(self.order_pos)

        def final_keys(cols, cap):
            ks = []
            for j, d, nu in order_pos:
                a = cols[f"#out{j}"]
                f = cols.get(f"#nullflag{j}")
                if f is not None:
                    a = _null_extreme_sub(a, f == 0, d, nu)
                ks.append(a)
            return ks + [cols["#upos"]]

        acc = dist_orderby(acc, final_keys,
                           [d for _j, d, _nu in order_pos] + [False], mesh)
        if self.offset or self.limit is not None:
            acc = dist_head(acc, self.offset or 0, self.limit, mesh)
        caps.append(("deliver", acc.local_capacity))
        self.last_tail_capacities = caps
        return ShardedBatch({n: acc.columns[n] for n in all_names},
                            acc.count).to_batch_device(mesh)

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
