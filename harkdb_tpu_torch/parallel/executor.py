"""Distributed query execution over a mesh of ranks.

Counterpart of ``harkdb_tpu.parallel.executor``. :func:`run_on_mesh` is
the one place that decides how a plan runs over a mesh: a ``QueryPlan``
through :class:`DistExecutor`, a set operation as the sharded UNION tail
(:func:`union_tail`) or as ``UnionPlan.execute`` over arms delivered to
every rank. The Context's queries, subqueries, derived tables and the
arms of set operations all run through it.

Every rank runs :meth:`DistExecutor.execute` on the same plan: its chunk
of each table is sharded once and cached (a derived table's inner result
once per execution: its host copy on its ``DerivedSource``, its blocks
made here for each binding), joins, windows and GROUP BY run
with exchanges (``dist_ops``, ``global_window``), and the tail (HAVING /
windows over grouped output / ORDER BY / OFFSET / LIMIT / projection /
DISTINCT) runs sharded (``config.dist_tail``) or on the gathered result
through the plan's own ``run_tail``. Every rank returns the whole result (the JAX
package's multi-process delivery: an all_gather), or, with
``deliver=False``, its block of the tail's projected result (the UNION
tail composes arms from those).

Ordering parity with the single-device path:

  * WHERE-only queries: rank blocks are contiguous original row ranges and
    local compaction is stable, so rank order is the original row order;
  * GROUP BY: ranks hold disjoint key sets; one range-partitioned sort
    (or one sort of the gathered groups) restores ascending key order;
  * JOIN and windows: hidden per-table row-id columns ride the exchanges;
    the result is sorted by (join keys, newest first, then row ids in
    binding order), which reproduces the single-device sorted, stable
    order.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.kernels.matmul_agg import MAX_KEY_SPAN, pad_span
from harkdb_tpu_torch.ops.sort import sort_batch, u32_order_key
from harkdb_tpu_torch.parallel.dist_ops import (
    dist_filter, dist_groupby, dist_head, dist_join, dist_map, dist_orderby,
    dist_window, shrink_sharded,
)
from harkdb_tpu_torch.parallel.global_window import (
    dist_global_window, supports_global,
)
from harkdb_tpu_torch.parallel.sharded import ShardedBatch, shard_batch
from harkdb_tpu_torch.plan.aggregates import apply_post_computes
from harkdb_tpu_torch.plan.derived import DerivedSource
from harkdb_tpu_torch.plan.expr import eval_expr
from harkdb_tpu_torch.plan.nulls import null_extreme_sub, valid_mask
from harkdb_tpu_torch.plan.planner import QueryPlan
from harkdb_tpu_torch.plan.union_plan import UnionPlan
from harkdb_tpu_torch.plan.windows import compute_windows


def run_on_mesh(plan, tables: Dict[str, Table], mesh,
                config: EngineConfig, shard_cache) -> ColumnBatch:
    """Run ``plan`` (a ``QueryPlan`` or a ``UnionPlan``) over ``mesh``;
    every rank returns the whole result. Inner plans (subqueries, derived
    tables, the arms of a set operation) run through it too.
    ``shard_cache`` is the Context's cache of table blocks."""
    if not isinstance(plan, UnionPlan):
        return DistExecutor(plan, mesh, config,
                            shard_cache=shard_cache).execute(tables)
    if config.dist_tail and all(op in ("union", "union all")
                                for op in plan.ops):
        return union_tail(plan, tables, mesh, config, shard_cache)
    return plan.execute(tables, execute=lambda p: run_on_mesh(
        p, tables, mesh, config, shard_cache))


class DistExecutor:
    def __init__(self, plan: QueryPlan, mesh,
                 config: EngineConfig = DEFAULT_CONFIG, shard_cache=None):
        self.plan = plan
        self.mesh = mesh
        self.config = config
        # (table name, binding, remap token) → this rank's resident block.
        # Owned by the Context, so tables are sharded once, not per query.
        self._shard_cache = shard_cache if shard_cache is not None else {}

    # -- table sharding -------------------------------------------------------
    def _shard_table(self, tables: Dict[str, Table],
                     binding_idx: int) -> ShardedBatch:
        b, tname, cols = self.plan.bindings[binding_idx]
        src = self.plan._source(tables, tname)
        # Merged-dictionary code remaps (string-key joins / cross-table
        # string comparisons) apply on the host before sharding; the cache
        # key carries the remap fingerprint.
        remaps = self.plan.load_remaps.get(b, {})
        key = None
        if isinstance(src, DerivedSource):
            # The inner query runs over the mesh once per execution (its
            # source keeps the host copy until the execution ends) and is
            # sharded again for this binding, outside the shard cache,
            # which is keyed by table name: two plans may give different
            # inner queries one alias.
            host, n = src.materialize_host(tables, self._run_inner)
        else:
            token = tuple(sorted(
                (i, hashlib.md5(lut.tobytes()).hexdigest())
                for i, lut in remaps.items()
            )) if remaps else None
            key = (tname, b, token)
            cached = self._shard_cache.get(key)
            if cached is not None:
                return cached
            host = {c: src.host_columns[c] for c in cols}
            n = src.n_rows
        block = {}
        for c, a in host.items():
            internal = f"{b}.{c}"
            lut = remaps.get(internal)
            block[internal] = lut[a] if lut is not None else a
        block[f"#rid.{b}"] = np.arange(n, dtype=np.int32)
        sb = shard_batch(block, n, self.mesh, self.config)
        if key is not None:
            self._shard_cache[key] = sb
        return sb

    # -- execution ------------------------------------------------------------
    def _pushdown(self, sb: ShardedBatch, binding: str) -> ShardedBatch:
        expr = self.plan.pushdown.get(binding)
        if expr is None:
            return sb
        return dist_filter(
            sb, lambda cols, cap: eval_expr(expr, cols, cap, self.config))

    def execute(self, tables: Dict[str, Table], deliver: bool = True):
        """Run the planned query over the mesh; every rank returns the
        whole result. ``deliver=False`` returns this rank's block of the
        tail's projected result (``#out`` / ``#nullflag`` columns, a
        :class:`ShardedBatch`) for the UNION tail to compose; the
        ``dist_tail=False`` path delivers all the same.

        Subqueries run first, over the mesh (:func:`run_on_mesh`), and
        their results are read back and substituted before the pipeline
        reads the expressions; they and the derived tables' results live
        for this call only (``QueryPlan.one_execution``)."""
        self._run_inner = lambda p: run_on_mesh(
            p, tables, self.mesh, self.config, self._shard_cache)
        with self.plan.one_execution(tables, execute=self._run_inner):
            return self._execute(tables, deliver)

    def _execute(self, tables: Dict[str, Table], deliver: bool):
        plan = self.plan
        self._deliver = deliver
        work = self._pushdown(self._shard_table(tables, 0),
                              plan.bindings[0][0])
        # Order-restoration chain: per join, newest first, the specs that
        # reproduce the single-device sorted-stable output order; rid_order
        # is the per-binding row-id tie chain (the incoming table first for
        # RIGHT joins — its rows are the preserved side of the swapped LEFT).
        restore_specs: List[tuple] = []
        rid_order: List[str] = [f"#rid.{plan.bindings[0][0]}"]
        for step_idx, (rb, lks, rks, kind) in enumerate(plan.join_steps):
            right = self._pushdown(self._shard_table(tables, 1 + step_idx), rb)
            kflags = list(plan.join_key_flags[step_idx])
            if kind == "right":
                work = dist_join(
                    right, work, rks, lks, self.mesh, self.config,
                    kind="left", matched_out=f"#lmatched.{rb}",
                    r_flag_names=kflags,
                )
                restore_specs = [("asc", k) for k in rks] + restore_specs
                rid_order.insert(0, f"#rid.{rb}")
                continue
            work = dist_join(
                work, right, list(lks), list(rks), self.mesh, self.config,
                kind=kind, matched_out=plan.null_flags.get(rb),
                l_matched_out=f"#lmatched.{rb}" if kind == "full" else None,
                l_flag_names=kflags,
            )
            # a nullable join key orders its NULL rows after the valid rows
            # of the tying key value (the concat sort's null code)
            nf_entry = [("nullflags", tuple(kflags))] if kflags else []
            if kind == "full":
                # single-device FULL = the left-join part (by key), then the
                # unmatched right rows in key order: the flag separates the
                # blocks, the merged key sorts within them
                restore_specs = (
                    [("desc", f"#lmatched.{rb}")]
                    + [("merge", f"#lmatched.{rb}", lk, rk)
                       for lk, rk in zip(lks, rks)]
                    + nf_entry + restore_specs
                )
            else:
                restore_specs = ([("asc", k) for k in lks] + nf_entry
                                 + restore_specs)
            rid_order.append(f"#rid.{rb}")

        def restore_entries(names) -> List:
            """Per-spec key builders over the columns present."""
            names = set(names)
            out = []
            for spec in restore_specs:
                if spec[0] == "merge":
                    _t, fl, ln, rn = spec
                    if {fl, ln, rn} <= names:
                        out.append(lambda cols, fl=fl, ln=ln, rn=rn:
                                   torch.where(cols[fl] != 0, cols[ln],
                                               cols[rn]))
                elif spec[0] == "nullflags":
                    fls = list(spec[1])
                    if set(fls) <= names:
                        out.append(lambda cols, fls=fls: 1 - valid_mask(
                            fls, cols).to(torch.int32))
                elif spec[1] in names:
                    if spec[0] == "desc":
                        out.append(lambda cols, k=spec[1]: -cols[k])
                    else:
                        out.append(lambda cols, k=spec[1]: cols[k])
            for r in rid_order:
                if r in names:
                    out.append(lambda cols, k=r: cols[k])
            return out

        self._restore_entries = restore_entries
        joined = bool(plan.join_steps)

        if plan.where_residual is not None:
            expr = plan.where_residual
            work = dist_filter(
                work, lambda cols, cap: eval_expr(expr, cols, cap,
                                                  self.config))

        if plan.window_specs and not plan.grouped:
            work = self._dist_windows(work)

        if plan.grouped:
            work = self._groupby(work)
            if self.config.dist_tail:
                return self._dist_tail(work, grouped=True)
            gathered = work.to_batch_device(self.mesh)
            # Disjoint key sets per rank → one global sort restores the
            # ascending-key output contract (u32 bit order under the
            # reference-compat flag).
            keys = list(plan.group_exec_keys) or ["#const"]
            if self.config.compat_u32_key_order:
                gathered = sort_batch(
                    gathered, [], key_arrays=[
                        u32_order_key(gathered.column(k)) for k in keys])
            else:
                gathered = sort_batch(gathered, keys)
        else:
            if self.config.dist_tail:
                return self._dist_tail(work, joined, grouped=False)
            gathered = work.to_batch_device(self.mesh)
            # window exchanges move rows off their ranks, so the gathered
            # result re-sorts by row id even without joins
            if joined or plan.window_specs:
                ka = [f(gathered.columns)
                      for f in restore_entries(gathered.columns)]
                gathered = sort_batch(gathered, [], [False] * len(ka),
                                      key_arrays=ka)
        return plan.run_tail(gathered)

    def _dist_windows(self, work: ShardedBatch,
                      tie_names: List[str] = None) -> ShardedBatch:
        """One exchange pass per distinct PARTITION BY: each partition
        lands wholly on one rank, the single-device window computation
        runs there, and window columns already computed ride later passes
        as payload (``dist_window``). Global windows (empty PARTITION BY)
        take the carry path (``global_window``; lag / lead through an
        edge-row halo); explicit ROWS frames and wide lag / lead offsets
        take the rank-0 route. ``tie_names`` replaces the row-id tie chain
        (grouped queries pass the exec group keys: their rows are
        groups)."""
        plan = self.plan
        by_parts: Dict[tuple, list] = {}
        for spec in plan.window_specs:
            by_parts.setdefault(spec[3], []).append(spec)
        for parts, specs in by_parts.items():
            if not parts:
                by_shape: Dict[tuple, list] = {}
                for s in specs:
                    by_shape.setdefault((s[4], s[5]), []).append(s)
                rest = []
                for shp_specs in by_shape.values():
                    if supports_global(shp_specs):
                        work = dist_global_window(work, shp_specs, self.mesh,
                                                  self.config,
                                                  tie_names=tie_names)
                    else:
                        rest.extend(shp_specs)
                if not rest:
                    continue
                specs = rest
            # each rank's local order is irrelevant: the tail re-sorts
            work = dist_window(
                work, parts,
                lambda b, _s=specs: compute_windows(plan, b, _s)[0],
                self.mesh)
        return work

    def _groupby(self, work: ShardedBatch) -> ShardedBatch:
        """GROUP BY over the ranks, with the implicit group's empty-input
        row (count 0, NULL aggregates) fabricated on rank 0."""
        plan, cfg = self.plan, self.config
        # exec keys include the hidden matched flag of any nullable group
        # key (NULL as its own group, as on one device)
        keys = list(plan.group_exec_keys) or ["#const"]
        need_ones = any(src == "#ones" for src, _, _ in plan.agg_specs)
        need_const = not plan.group_keys

        def pre_fn(cols, cap):
            extra = {}
            for name, ge in plan.group_key_exprs:
                extra[name] = eval_expr(ge, cols, cap, cfg)
            for name in keys:
                dfe = plan.derived_flag_cols.get(name)
                if dfe is not None:
                    extra[name] = eval_expr(dfe, cols, cap, cfg).to(
                        torch.int32)
            for internal, e in plan.agg_arg_cols:
                extra[internal] = eval_expr(e, cols, cap, cfg)
            dev = next(iter(cols.values())).device
            if need_ones:
                extra["#ones"] = torch.ones(cap, dtype=torch.int32,
                                            device=dev)
            if need_const:
                extra["#const"] = torch.zeros(cap, dtype=torch.int32,
                                              device=dev)
            return extra

        # The dense-key path distributed: the planner's gate (one small-span
        # int key, sum / count only) runs kernel C in every rank's local
        # pre-aggregate. The span is proven from the tables' statistics
        # (no join) or measured by one all-reduced min / max probe over the
        # live rows, cached on the plan.
        fast = None
        if plan.fast_agg is not None and not plan.join_steps:
            _key, key_min, span_p = plan.fast_agg
            fast = (key_min, span_p)
        elif plan.fast_candidate is not None:
            fast = self._probe_fast_dist(work)
        plan.last_fast_span = fast[1] if fast is not None else None

        work = dist_groupby(work, keys, list(plan.agg_specs), self.mesh,
                            pre_fn, fast=fast)
        if plan.group_keys:
            return work
        # SQL: an ungrouped aggregate over EMPTY input is one row (count 0,
        # sums 0), not zero rows — rank 0 fabricates it when the global
        # group count is zero (min/max padding is op-neutral, so slot 0
        # zeroes explicitly); #grp_has is the implicit group's validity.
        total = self.mesh.all_reduce(work.count.reshape(1), "sum")[0]
        mk = (total == 0) & (self.mesh.rank == 0)
        cols = {}
        for name, cc in work.columns.items():
            cc = cc.clone()
            cc[0] = torch.where(mk, torch.zeros_like(cc[0]), cc[0])
            cols[name] = cc
        cols["#grp_has"] = (total > 0).to(torch.int32).expand(
            work.local_capacity).clone()
        return ShardedBatch(cols, torch.where(mk, 1, work.count).to(
            torch.int32))

    def _probe_fast_dist(self, work: ShardedBatch):
        """The distributed form of ``QueryPlan._resolve_fast``'s probe: the
        group key's (min, max, any) over every rank's live rows, in one
        all_reduce, read back once and cached on the plan."""
        plan, cfg = self.plan, self.config
        cached = getattr(plan, "_probed_fast_dist", None)
        if cached is not None:
            return cached if cached != () else None
        k = work.columns[plan.fast_candidate]
        live = torch.arange(work.local_capacity, dtype=torch.int32,
                            device=k.device) < work.count
        info = torch.iinfo(k.dtype)
        kmin = torch.where(live, k, info.max).min().to(torch.int64)
        kmax = torch.where(live, k, info.min).max().to(torch.int64)
        neg_min, kmax, nonempty = self.mesh.all_reduce(torch.stack(
            [-kmin, kmax, live.any().to(torch.int64)]), "max").tolist()
        fast = None
        if nonempty:
            kmin = -neg_min
            if not (cfg.compat_u32_key_order and kmin < 0):
                span = kmax - kmin + 1
                if span <= MAX_KEY_SPAN:
                    fast = (kmin, pad_span(span))
        plan._probed_fast_dist = fast if fast is not None else ()
        return fast

    def _dist_tail(self, work: ShardedBatch, joined: bool = False,
                   grouped: bool = False) -> ColumnBatch:
        """Sharded post-pipeline tail: HAVING / ORDER BY / OFFSET / LIMIT /
        projection run on every rank's block, so no rank holds the whole row
        or group set before delivery.

        Ungrouped: ORDER BY is a range-partitioned sort (``dist_orderby``)
        whose tie chain — order keys, then join keys and row ids, then the
        pre-shuffle position — gives the single-device stable order.
        Grouped: ranks hold disjoint key sets, so HAVING is a local filter,
        avg / null-fix derivations are local maps, and the ascending-key
        contract (or the user's ORDER BY, ties broken by the exec group
        keys) is one ``dist_orderby``. OFFSET / LIMIT take each rank's slice
        of the global window (``dist_head``). Delivery is an all_gather:
        every rank returns the whole result. ``last_tail_capacities``
        records (stage, this rank's capacity).
        """
        plan, cfg, mesh = self.plan, self.config, self.mesh
        final_items = list(plan.final_items)
        caps = [("in", work.local_capacity)]
        post = list(plan.post_computes) if grouped else []

        def aug(cols, cap):
            """Post-aggregation derived columns (avg / variance / null
            fixes) for HAVING / ORDER BY / projection expressions."""
            if not post:
                return cols
            g = dict(cols)
            apply_post_computes(g, post)
            return g

        if grouped and plan.having is not None:
            hv = plan.having
            work = dist_filter(
                work, lambda cols, cap: eval_expr(hv, aug(cols, cap), cap,
                                                  cfg))
            caps.append(("having", work.local_capacity))

        if grouped and plan.window_specs:
            # Windows over the grouped output (after HAVING, the standard
            # SQL order). Their arguments may read avg / null-fix derived
            # columns: those are materialised once, then the windows run
            # over the sharded groups, ties broken by the exec group keys
            # (unique per row), as on one device.
            if post:
                work = dist_map(work, aug)
                post.clear()                   # aug becomes a no-op
            work = self._dist_windows(
                work, tie_names=[k for k in plan.group_exec_keys
                                 if k in work.columns])
            caps.append(("windows", work.local_capacity))

        out_names = [f"#out{i}" for i in range(len(final_items))]
        # Hidden NULL indicators per nullable output, as run_tail emits them
        # on one device. A flag may be a post-compute output (sample
        # variance validity), available only after aug.
        post_outs = {o for o, _s in post}
        nf_specs = [
            (i, flags)
            for i, flags in enumerate(plan.output_null_flags)
            if flags and plan._flags_available(
                flags, set(work.names) | post_outs)
        ]
        out_names = out_names + [f"#nullflag{i}" for i, _f in nf_specs]

        def project(cols, cap):
            g = aug(cols, cap)
            out = {f"#out{i}": eval_expr(e, g, cap, cfg)
                   for i, (e, _n) in enumerate(final_items)}
            for i, flags in nf_specs:
                out[f"#nullflag{i}"] = plan._valid_arr(flags, g, cap).to(
                    torch.int32)
            return out

        if plan.distinct:
            # DISTINCT = group-by over the whole output tuple: project on
            # every rank, dedupe, exchange by the tuple's hash, dedupe. The
            # single-device order is lexicographic by the tuple with ORDER
            # BY applied stably on top: (order outputs, whole tuple) is the
            # sort's key chain (tuples are unique, so the order is total).
            work = dist_map(work, project)
            work = dist_groupby(work, out_names, [], mesh)
            descs = [d for _e, d in plan.order_items]
            descs += [False] * len(out_names)

            def dkeys_fn(cols, cap):
                ks = []
                for (j, (_e, d)), nu in zip(
                    zip(plan.order_out_idx, plan.order_items),
                    plan.order_nulls,
                ):
                    a = cols[f"#out{j}"]
                    nf = cols.get(f"#nullflag{j}")
                    if nf is not None:
                        a = null_extreme_sub(a, nf == 0, d, nu)
                    ks.append(a)
                return ks + [cols[k] for k in out_names]

            work = dist_orderby(work, dkeys_fn, descs, mesh)
            caps.append(("distinct", work.local_capacity))
        else:
            tie_names: List[str] = []
            tie_fns: List = []
            u32_ties = False
            if grouped:
                # ranks hold disjoint key sets in hash order; one range
                # partition restores the global ascending-key contract, the
                # exec keys breaking the user's ORDER BY's ties
                tie_names = [k for k in plan.group_exec_keys
                             if k in work.columns]
                u32_ties = cfg.compat_u32_key_order
            elif joined or plan.window_specs:
                # the join restore chain (keys / outer-join flags / row
                # ids) reproduces the single-device order; window
                # exchanges moved rows off their ranks
                tie_fns = self._restore_entries(work.names)

            order_exprs = list(plan.order_items)
            if order_exprs or tie_names or tie_fns:
                descs = [d for _e, d in order_exprs]
                descs += [False] * (len(tie_names) + len(tie_fns))

                def keys_fn(cols, cap):
                    g = aug(cols, cap)
                    ks = [plan._null_adjusted_key(e, d, nu, g, cap)
                          for (e, d), nu in zip(order_exprs,
                                                plan.order_nulls)]
                    if u32_ties:
                        ks += [u32_order_key(cols[k]) for k in tie_names]
                    else:
                        ks += [cols[k] for k in tie_names]
                    return ks + [f(cols) for f in tie_fns]

                work = dist_orderby(work, keys_fn, descs, mesh)
                caps.append(("orderby", work.local_capacity))
            work = dist_map(work, project)

        if plan.offset or plan.limit is not None:
            work = dist_head(work, plan.offset or 0, plan.limit, mesh)
            caps.append(("head", work.local_capacity))
        self.last_tail_capacities = caps
        if not self._deliver:
            return work
        return work.to_batch_device(mesh)


def union_tail(plan: UnionPlan, tables: Dict[str, Table], mesh,
               config: EngineConfig, shard_cache) -> ColumnBatch:
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
    n_out = len(plan.output_names)
    out_names = [f"#out{j}" for j in range(n_out)]
    caps = []

    # Every arm runs sharded first, so the union-wide set of NULL
    # indicators is known before any arm is normalised to it.
    arm_sbs = [DistExecutor(p, mesh, config, shard_cache=shard_cache)
               .execute(tables, deliver=False) for p in plan.arms]
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
        luts = {j: torch.as_tensor(plan.code_remaps[j][ai]).to(
                    mesh.device)
                for j in range(n_out)
                if plan.code_remaps[j] is not None
                and plan.code_remaps[j][ai] is not None}
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
                    plan.check_span(int(mesh.all_reduce(m.reshape(1),
                                                         "max")))
            casts.append(name)
        if casts:
            tgt = plan.float_target()

            def cast_fn(cols, cap, _c=tuple(casts)):
                return {n: c.to(tgt) if n in _c else c
                        for n, c in cols.items()}

            acc, sb = dist_map(acc, cast_fn), dist_map(sb, cast_fn)
        acc = shrink_sharded(concat(acc, sb), mesh)
        caps.append((f"concat{ai}", acc.local_capacity))
        if plan.ops[ai - 1] == "union":
            acc, base = dedupe(acc)
            caps.append((f"dedupe{ai}", acc.local_capacity))

    # The final global order: the trailing ORDER BY's outputs (NULL
    # placement by the indicators), ties by #upos — the single-device
    # stable sort over the concatenation / dedupe order.
    order_pos = list(plan.order_pos)

    def final_keys(cols, cap):
        ks = []
        for j, d, nu in order_pos:
            a = cols[f"#out{j}"]
            f = cols.get(f"#nullflag{j}")
            if f is not None:
                a = null_extreme_sub(a, f == 0, d, nu)
            ks.append(a)
        return ks + [cols["#upos"]]

    acc = dist_orderby(acc, final_keys,
                       [d for _j, d, _nu in order_pos] + [False], mesh)
    if plan.offset or plan.limit is not None:
        acc = dist_head(acc, plan.offset or 0, plan.limit, mesh)
    caps.append(("deliver", acc.local_capacity))
    plan.last_tail_capacities = caps
    return ShardedBatch({n: acc.columns[n] for n in all_names},
                        acc.count).to_batch_device(mesh)
