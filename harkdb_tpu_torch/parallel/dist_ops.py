"""Distributed operators: filter / group-by / window / order-by / head / map
/ join over each rank's block.

Counterpart of ``harkdb_tpu.parallel.dist_ops``. Every function
runs on every rank, SPMD, on that rank's :class:`ShardedBatch`, built from
the same single-device operators (``harkdb_tpu_torch.ops``): the
distributed layer composes, it does not reimplement.

Ranks must take the same branches, or one rank enters a collective the
others skip and the job hangs: every host decision here reads a value that
is the same on every rank (an all-reduced or all-gathered one, or the
plan's), never a rank-local one, except where the decision is local and no
collective follows from it (a block's own capacity).

Collectives per operator: filter / map none; head one all_gather of the
counts; group-by one exchange (``shuffle.exchange``) after the local
pre-aggregate; window one exchange; order-by one sample all_gather and
one exchange; join two
exchanges (both sides co-partitioned), with salting one more all_gather.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.kernels.matmul_agg import onehot_groupby_sums
from harkdb_tpu_torch.ops.groupby import groupby_batch
from harkdb_tpu_torch.ops.join import compute_join_ranges, join_batches
from harkdb_tpu_torch.ops.sort import ieee_order_view, sort_batch
from harkdb_tpu_torch.parallel.sharded import ShardedBatch, block_capacity
from harkdb_tpu_torch.parallel.shuffle import (
    hash_to_bucket, repartition_with_dest,
)
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.plan.nulls import valid_mask
from harkdb_tpu_torch.prims.compaction import compact_batch, compact_indices

Tensor = torch.Tensor

# How each aggregate op re-aggregates across ranks: op on partials.
REAGG = {"sum": "sum", "count": "sum", "min": "min", "max": "max",
         "prod": "prod"}

SAMPLES_PER_SHARD = 64


def hash_keys(cols: Dict[str, Tensor], key_names: Sequence[str],
              n_shards: int, salt: int = 0) -> Tensor:
    """Combined bucket id for (possibly multi-) key rows."""
    dest = hash_to_bucket(cols[key_names[0]], n_shards, salt)
    for i, k in enumerate(key_names[1:], start=1):
        extra = hash_to_bucket(cols[k], n_shards, salt + 31 * i)
        dest = (dest + extra) % n_shards
    return dest


def _take(cols: Dict[str, Tensor], idx: Tensor, n_out: Tensor
          ) -> Dict[str, Tensor]:
    """Gather the rows ``compact_indices`` listed; rows past ``n_out`` are
    0 (``col.at[idx].get(mode="fill", fill_value=0)`` in JAX)."""
    cap = idx.shape[0]
    live = torch.arange(cap, dtype=torch.int32, device=idx.device) < n_out
    safe = torch.where(live, idx, 0).long()
    return {n: torch.where(live, c[safe], torch.zeros((), dtype=c.dtype,
                                                      device=c.device))
            for n, c in cols.items()}


def shrink_sharded(sb: ShardedBatch, mesh) -> ShardedBatch:
    """Cut every rank's block to ``block_capacity`` of the largest live
    count over the ranks (all-reduced, so capacities stay the same on
    every rank). The local pre-aggregate keeps its input's capacity; cut,
    its exchange partitions the live groups, not the input's rows. (An
    exchange's output is sized to its rows already, so JAX's shrinks after
    each shuffle have no counterpart here.)"""
    ml = int(mesh.all_reduce(sb.count.reshape(1), "max"))
    c2 = block_capacity(max(ml, 1))
    if c2 >= sb.local_capacity:
        return sb
    return ShardedBatch({n: c[:c2] for n, c in sb.columns.items()}, sb.count)


def dist_filter(sb: ShardedBatch,
                mask_fn: Callable[[Dict[str, Tensor], int], Tensor]
                ) -> ShardedBatch:
    """Row-parallel WHERE: local masked compaction (kernel A over an iota
    column), no collectives."""
    mask = mask_fn(sb.columns, sb.local_capacity).to(torch.bool)
    idx, n_out = compact_indices(mask, sb.count)
    return ShardedBatch(_take(sb.columns, idx, n_out), n_out)


def dist_groupby(
    sb: ShardedBatch,
    key_names: Sequence[str],
    agg_specs: Sequence[Tuple[str, str, str]],
    mesh,
    pre_fn: Optional[Callable[[Dict[str, Tensor], int],
                              Dict[str, Tensor]]] = None,
    fast: Optional[Tuple[int, int]] = None,
) -> ShardedBatch:
    """Distributed GROUP BY: local pre-aggregate → exchange of the partials
    by key hash → local final aggregate. Output ranks hold disjoint key
    sets, each sorted ascending.

    ``pre_fn`` derives extra columns (aggregate-argument expressions) on the
    local block first. QUANTILE / MEDIAN cannot re-aggregate from partials:
    the raw rows are exchanged and the whole group-by runs on the receiving
    rank. COUNT(DISTINCT) pre-groups at (keys + distinct sources)
    granularity and routes on the real keys' hash. ``fast = (key_min,
    span)`` runs the local pre-aggregate through the dense-key path (kernel
    C on a card): one int key, sum / count only, the single-device gate.
    """
    D = mesh.size
    C = sb.local_capacity
    key_names = list(key_names)
    cols = dict(sb.columns)
    if pre_fn is not None:
        cols.update(pre_fn(cols, C))

    if any(str(op).startswith("quantile@") for _s, op, _o in agg_specs):
        keep = set(key_names) | {s[2] for s in agg_specs}
        shuf, shuf_n = repartition_with_dest(
            cols, hash_keys(cols, key_names, D), sb.count, mesh)
        final = groupby_batch(ColumnBatch(shuf, shuf_n), key_names,
                              agg_specs)
        return ShardedBatch(
            {n: c for n, c in final.columns.items() if n in keep},
            final.n_valid)

    countd_srcs: List[str] = []
    for src, op, _ in agg_specs:
        if op == "countd":
            # NULL-skipping countd srcs are (value, valid) pairs — both
            # ride the fine-grained pre-grouping (ops/groupby.py).
            for s in (src if isinstance(src, tuple) else (src,)):
                if s not in countd_srcs:
                    countd_srcs.append(s)
    if countd_srcs:
        pre_keys = key_names + [s for s in countd_srcs if s not in key_names]
        pre_specs = [(s, op, out) for s, op, out in agg_specs
                     if op != "countd"]
        post_specs = [
            (src, "countd", out) if op == "countd"
            else (out, REAGG[op], out)
            for src, op, out in agg_specs
        ]
    else:
        pre_keys = key_names
        pre_specs = list(agg_specs)
        post_specs = [(out, REAGG[op], out) for _src, op, out in agg_specs]

    if fast is not None and not countd_srcs and len(key_names) == 1:
        key_min, span = fast
        key = key_names[0]
        sum_srcs = list(dict.fromkeys(
            src for src, op, _ in agg_specs if op == "sum"))
        counts_k, sums_k, keys_axis = onehot_groupby_sums(
            cols[key], [cols[s] for s in sum_srcs], sb.count, key_min, span)
        sums_by_src = dict(zip(sum_srcs, sums_k))
        gcols = {key: keys_axis}
        for src, op, out_name in agg_specs:
            gcols[out_name] = counts_k if op == "count" else sums_by_src[src]
        partial = compact_batch(
            ColumnBatch(gcols, torch.full((), span, dtype=torch.int32,
                                          device=keys_axis.device)),
            counts_k > 0)
    else:
        partial = groupby_batch(ColumnBatch(cols, sb.count), pre_keys,
                                pre_specs)
    p = shrink_sharded(ShardedBatch(partial.columns, partial.n_valid), mesh)

    shuf, shuf_n = repartition_with_dest(
        p.columns, hash_keys(p.columns, key_names, D), p.count, mesh)
    final = groupby_batch(ColumnBatch(shuf, shuf_n), key_names, post_specs)
    keep = set(key_names) | {out for _, _, out in post_specs}
    return ShardedBatch({n: c for n, c in final.columns.items() if n in keep},
                        final.n_valid)


def dist_window(
    sb: ShardedBatch,
    part_names: Sequence[str],
    compute_fn: Callable[[ColumnBatch], ColumnBatch],
    mesh,
) -> ShardedBatch:
    """Distributed window functions for one PARTITION BY shape.

    Rows exchange on the partition keys' hash, so every partition lands
    wholly on one rank; the single-device window computation
    (``compute_fn``: ``plan/windows.compute_windows`` over this shape's
    specs) then runs on each rank's block and is globally correct.
    Window columns computed by an earlier shape ride the exchange as
    payload, so several shapes chain as passes. Rows stay where the
    exchange put them: the executor's tail restores the order (row id /
    join key / ORDER BY sort). An empty PARTITION BY sends every live row
    to rank 0 (the split-size exchange needs no retry to fit them)."""
    if part_names:
        dest = hash_keys(sb.columns, list(part_names), mesh.size)
    else:
        dest = torch.zeros(sb.local_capacity, dtype=torch.int32,
                           device=sb.count.device)
    shuf, shuf_n = repartition_with_dest(sb.columns, dest, sb.count, mesh)
    out = compute_fn(ColumnBatch(shuf, shuf_n))
    return ShardedBatch(out.columns, out.n_valid)


def dist_orderby(
    sb: ShardedBatch,
    keys_fn: Callable[[Dict[str, Tensor], int], Sequence[Tensor]],
    descending: Sequence[bool],
    mesh,
) -> ShardedBatch:
    """Distributed ORDER BY: sample-based range partition → one exchange →
    local stable multi-key sort. The output stays sharded: rank i holds the
    i-th contiguous range of the global order, so the blocks in rank order
    are the globally ordered result.

    Splitters come from ``SAMPLES_PER_SHARD`` evenly spaced live rows per
    rank (all_gathered, sorted, D-1 quantiles); rows equal to a splitter
    all go to one rank. Ties across the whole key list resolve by the
    pre-shuffle global position (rank-major), the single-device stable
    sort's tie order: the exchange delivers rows sender by sender, each in
    its local order, and the local sort is stable, so that position needs
    no column of its own (JAX carries it as ``#ord_gid``).
    """
    descending = list(descending)
    C = sb.local_capacity
    n_local = sb.count
    dev = n_local.device
    rk = ieee_order_view(keys_fn(sb.columns, C)[0], descending[0])
    S = SAMPLES_PER_SHARD
    sidx = (torch.arange(S, dtype=torch.int64, device=dev)
            * torch.clamp(n_local, min=1)) // S
    samp = rk[torch.clamp(sidx, max=C - 1)]
    g = mesh.all_gather(samp).reshape(-1)
    gv = mesh.all_gather((n_local > 0).to(torch.int32).reshape(1))
    gv = gv.expand(mesh.size, S).reshape(-1) > 0
    hi = torch.iinfo(g.dtype).max
    gs = torch.sort(torch.where(gv, g, hi)).values
    n_samp = gv.sum()
    pos = (torch.arange(1, mesh.size, device=dev) * n_samp) // mesh.size
    splitters = gs[torch.clamp(pos, max=mesh.size * S - 1)]
    dest = torch.searchsorted(splitters, rk).to(torch.int32)
    shuf, shuf_n = repartition_with_dest(sb.columns, dest, n_local, mesh)
    keys2 = list(keys_fn(shuf, next(iter(shuf.values())).shape[0]))
    out = sort_batch(ColumnBatch(shuf, shuf_n), [], descending,
                     key_arrays=keys2)
    return ShardedBatch(out.columns, out.n_valid)


def dist_head(sb: ShardedBatch, offset: int, limit: Optional[int],
              mesh) -> ShardedBatch:
    """Distributed OFFSET/LIMIT over the global row window ``[offset,
    offset + limit)`` in rank order (= the global order after
    :func:`dist_orderby`, or the table's row order): each rank keeps its
    slice of the window; one all_gather of the counts, no row moves."""
    n_local = sb.count.to(torch.int64)
    gc = mesh.all_gather(sb.count.reshape(1)).reshape(-1).to(torch.int64)
    prefix = gc[:mesh.rank].sum()
    zero = torch.zeros((), dtype=torch.int64, device=n_local.device)
    start = torch.minimum(torch.maximum(offset - prefix, zero), n_local)
    end = n_local
    if limit is not None:
        end = torch.minimum(torch.maximum(offset + limit - prefix, zero),
                            n_local)
    pos = torch.arange(sb.local_capacity, device=n_local.device)
    idx, n_out = compact_indices((pos >= start) & (pos < end), sb.count)
    return ShardedBatch(_take(sb.columns, idx, n_out), n_out)


def dist_map(sb: ShardedBatch,
             fn: Callable[[Dict[str, Tensor], int], Dict[str, Tensor]]
             ) -> ShardedBatch:
    """Row-parallel column map (projection / expressions): ``fn(cols,
    capacity) -> new column dict`` on each block, no collectives."""
    return ShardedBatch(dict(fn(sb.columns, sb.local_capacity)), sb.count)


def dist_join(
    left: ShardedBatch,
    right: ShardedBatch,
    l_key,
    r_key,
    mesh,
    config: EngineConfig = DEFAULT_CONFIG,
    kind: str = "inner",
    matched_out: Optional[str] = None,
    l_matched_out: Optional[str] = None,
    l_flag_names: Sequence[str] = (),
    r_flag_names: Sequence[str] = (),
) -> ShardedBatch:
    """Distributed equi-join: co-partition both sides by key hash (two
    exchanges), then the single-device join on every rank (``ops.join``:
    one ranges pass, then materialization through kernel D). All rows of a
    key tuple meet on one rank, so inner / left / FULL OUTER run locally.
    ``l_key`` / ``r_key`` may be lists (multi-key); empty lists are a CROSS
    JOIN (every row goes to rank 0).

    With ``config.skew_salted_join`` a single-key inner or left join salts
    the probe side's hot keys and replicates their build rows
    (``parallel/skew.py``); FULL OUTER never salts (a build replica on a
    rank without its probe rows would append as unmatched there).

    ``l_flag_names`` / ``r_flag_names`` are flag columns guarding each
    side's keys: a row with any flag 0 has a NULL key and matches nothing.
    Output columns: [left | right | matched_out | l_matched_out]; the
    executor restores the global order (hidden row ids ride along).
    """
    from harkdb_tpu_torch.parallel.skew import (
        detect_hot_keys, is_member, replicate_hot_build, salted_probe_dest,
    )

    D = mesh.size
    l_keys = [l_key] if isinstance(l_key, str) else list(l_key)
    r_keys = [r_key] if isinstance(r_key, str) else list(r_key)
    cross = not l_keys
    if kind == "cross":
        kind = "inner"
    salted = (config.skew_salted_join and D > 1
              and len(l_keys) == 1 and not cross and kind != "full")
    l_cols, r_cols = left.columns, right.columns

    if salted:
        lk0, rk0 = l_keys[0], r_keys[0]
        H, HV = detect_hot_keys(l_cols[lk0], left.count, D,
                                config.skew_threshold, mesh)
        l_hot = is_member(l_cols[lk0], H, HV)
        l_dest = salted_probe_dest(l_cols[lk0], l_hot, D, mesh.rank)
        ls, ln = repartition_with_dest(l_cols, l_dest, left.count, mesh)
        r_hot = is_member(r_cols[rk0], H, HV)
        r_live = (torch.arange(right.local_capacity, dtype=torch.int32,
                               device=r_hot.device) < right.count)
        n_r, n_hot = torch.stack([right.count.to(torch.int64),
                                  (r_hot & r_live).sum()]).tolist()
        exp_cols, exp_n, r_dest = replicate_hot_build(
            r_cols, rk0, right.count, r_hot, D,
            block_capacity(n_r + (D - 1) * n_hot))
        rs, rn = repartition_with_dest(exp_cols, r_dest, exp_n, mesh)
    else:
        def dest_of(sb: ShardedBatch, keys: List[str]) -> Tensor:
            if cross:
                return torch.zeros(sb.local_capacity, dtype=torch.int32,
                                   device=sb.count.device)
            return hash_keys(sb.columns, keys, D)

        ls, ln = repartition_with_dest(l_cols, dest_of(left, l_keys),
                                       left.count, mesh)
        rs, rn = repartition_with_dest(r_cols, dest_of(right, r_keys),
                                       right.count, mesh)

    def null_of(cols, flags):
        return ~valid_mask(list(flags), cols) if flags else None

    def keys_of(cols, keys):
        if keys:
            return [cols[k] for k in keys]
        first = next(iter(cols.values()))
        return [torch.zeros(first.shape[0], dtype=torch.int32,
                            device=first.device)]

    l_out = {n: n for n in ls}
    r_out = {n: n for n in rs if n not in l_out}
    ranges = compute_join_ranges(
        keys_of(ls, l_keys), ln, keys_of(rs, r_keys), rn,
        l_cols=[ls[n] for n in l_out], r_cols=[rs[n] for n in r_out],
        l_null=null_of(ls, l_flag_names), r_null=null_of(rs, r_flag_names),
        need_full=kind == "full",
    )
    cnt = (ranges.total_left if kind == "left"
           else ranges.total_full if kind == "full" else ranges.total)
    # The wrap guard reads the all-reduced approximate total, so every rank
    # raises or none does; each rank sizes its output from its own count.
    apx = mesh.all_reduce(ranges.total_approx.reshape(1), "max")
    local, apx_max = torch.cat([cnt.reshape(1).to(torch.float64),
                                apx.to(torch.float64)]).tolist()
    if apx_max > 1.8e9:
        raise PlanError(
            f"Join result would exceed ~1.8e9 pairs on one shard "
            f"(≈{apx_max:.3g}) — beyond the 2^31-row capacity; "
            f"add join keys or filters"
        )
    out = join_batches(
        None, None, None, None, block_capacity(int(local)), l_out, r_out,
        kind=kind, ranges=ranges, matched_out=matched_out,
        l_matched_out=l_matched_out,
    )
    return ShardedBatch(out.columns, out.n_valid)
