"""GROUP BY aggregation (reference semantics: ``groupby.fut:51-62``).

Counterpart of ``harkdb_tpu.ops.groupby``, with the same algorithm and the
same output contract (SURVEY §3.4): one row per distinct key, **ascending
key order**, column 0 = key, remaining columns = aggregates in select-list
order. ``u32_key_order=True`` reproduces the reference's u32 key order.

  1. ONE stable sort on (dropped-mask, keys...) (``ops.sort``), carrying
     every aggregate input column as a gathered payload; a WHERE predicate
     fuses in as the leading sort key;
  2. boundary flags on the sorted keys mark segment starts/ends;
  3. per-segment values are produced as *row-level scans*: integer sums and
     counts via a global int32 cumsum + telescoping differences at segment
     ends (exact mod 2^32); float sums and max/min/prod via kernel B
     (``kernels.segscan.agg_segscan``);
  4. ONE compaction (kernel A, ``prims.compaction.compact_arrays``) packs
     every segment-end row (keys + all scan results + row position) to the
     front in key order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.kernels.segscan import (
    agg_neutral, agg_segscan, flat_segscan,
)
from harkdb_tpu_torch.ops.sort import lexsort_permutation, u32_order_key
from harkdb_tpu_torch.prims.compaction import compact_arrays
from harkdb_tpu_torch.prims.scan import running_max, running_min

Tensor = torch.Tensor

#: Aggregate name → the binary op that combines two partial results
#: (``harkdb_tpu.ops.groupby.AGG_FUNCS``).
AGG_FUNCS: Dict[str, Callable] = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
    "count": torch.add,
    "countd": torch.add,     # COUNT(DISTINCT x): distinct counts add up
}


def groupby_aggregate(
    keys: Union[Tensor, Sequence[Tensor]],
    agg_cols: Sequence[Tuple[Tensor, str]],
    n_valid: Tensor,
    mask: Optional[Tensor] = None,
    u32_key_order: bool = False,
) -> Tuple[List[Tensor], List[Tensor], Tensor]:
    """Aggregate ``agg_cols`` (value, op-name) per distinct key tuple.

    ``keys`` is one tensor or a list (multi-key lexicographic grouping).
    ``mask`` optionally restricts the aggregation to rows where it is True
    (a fused WHERE predicate — it rides the sort as the leading key).
    ``u32_key_order`` orders output groups by the keys' u32 bit patterns.
    Returns ``(keys_out, agg_outs, n_groups)`` — all padded to the input
    capacity; rows at index >= n_groups are padding.
    """
    if not isinstance(keys, (list, tuple)):
        keys = [keys]
    keys = list(keys)
    orig_dtypes = [k.dtype for k in keys]
    if u32_key_order:
        # XOR preserves equality, so segmenting logic is unchanged; only the
        # sort order differs. Undone on the output keys below.
        keys = [u32_order_key(k) for k in keys]
    nk = len(keys)
    n = keys[0].shape[0]
    dev = keys[0].device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid_in = idx < n_valid
    if mask is not None:
        valid_in = valid_in & mask

    # ONE sort: dropped-mask leading (live rows pack to the front in key
    # order), then the keys; aggregate inputs follow as gathered payload.
    # COUNT(DISTINCT) and quantile columns get their own auxiliary sort
    # where they participate as a KEY (below).
    dropped = ~valid_in
    payload = [
        col for col, op in agg_cols
        if op not in ("count", "countd")
        and not str(op).startswith("quantile@")
    ]
    perm = lexsort_permutation([dropped] + keys)
    sorted_keys = [k[perm] for k in keys]
    sorted_payload = [p[perm] for p in payload]
    count = valid_in.sum(dtype=torch.int32)
    valid = idx < count

    # Segment starts/ends from key changes between adjacent live rows.
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    for skey in sorted_keys:
        prev = torch.cat([skey[:1], skey[:-1]])
        changed = changed | (skey != prev)
    is_start = valid & ((idx == 0) | changed)
    n_groups = is_start.sum(dtype=torch.int32)
    next_start = torch.cat([is_start[1:], is_start.new_zeros(1)])
    is_end = valid & (next_start | (idx == count - 1))

    # Row-level scan per op class (no scatters):
    #   * int sum  → global cumsum; telescoping differences at segment ends
    #     are exact under two's-complement wraparound;
    #   * float sum / max / min / prod → kernel B;
    #   * count → row positions; per-group counts are position differences.
    plans: List[Tuple[str, int]] = []          # per agg: (post-kind, slot)
    cum_cols: List[Tensor] = []
    scan_groups: Dict[Tuple[str, torch.dtype], List[Tuple[int, Tensor]]] = {}
    need_pos = False
    pay_i = 0
    for ai, (_col, op) in enumerate(agg_cols):
        if op == "count":
            plans.append(("count", -1))
            need_pos = True
            continue
        if op == "countd":
            plans.append(("countd", -1))   # slot patched below
            continue
        if str(op).startswith("quantile@"):
            plans.append(("quantile", -1))  # slot patched below
            continue
        col = sorted_payload[pay_i]
        pay_i += 1
        if op == "sum" and not col.dtype.is_floating_point \
                and col.dtype != torch.bool:
            plans.append(("telescope", len(cum_cols)))
            cum_cols.append(col)
        else:
            scan_groups.setdefault((op, col.dtype), []).append((ai, col))
            plans.append(("scan", -1))         # slot patched below

    end_arrays: List[Tensor] = []               # compaction payload
    slot_of: Dict[int, int] = {}                # agg index → end_arrays slot
    cum_base = 0
    if cum_cols:
        # One 1-D scan per column: torch's CUDA cumsum along dim 0 of an
        # [n, C] stack scans each column serially in one thread (TPC-H Q1
        # at SF 1, C = 3, took 644 ms on an H100 that way; PERF.md §6).
        cum_base = len(end_arrays)
        end_arrays.extend(torch.cumsum(c, 0, dtype=c.dtype)
                          for c in cum_cols)
    sid = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    for (op, _dt), members in scan_groups.items():
        scanned = agg_segscan(op, sid, [c for _ai, c in members])
        for (ai, _c), col_scan in zip(members, scanned):
            slot_of[ai] = len(end_arrays)
            end_arrays.append(col_scan)

    # COUNT(DISTINCT x): one auxiliary sort per distinct column where x rides
    # as an extra trailing KEY — within each group's segment the values are
    # then sorted, so the distinct count is the number of value-change
    # boundaries. Group-boundary positions depend only on the multiset of
    # (dropped, keys), so the MAIN sort's is_start/is_end flags apply
    # verbatim and the cumsum telescopes at the shared segment ends.
    #
    # NULL-skipping form: the column may be a (value, valid01) PAIR — the
    # inverted valid flag rides as a key BEFORE the value, sorting a group's
    # NULL rows after its valid rows, and only valid-row value boundaries
    # count.
    for ai, (col, op) in enumerate(agg_cols):
        if op != "countd":
            continue
        if isinstance(col, tuple):
            val_col, valid_col = col
            inv = valid_col == 0
            p2 = lexsort_permutation([dropped] + keys + [inv, val_col])
            x_s, inv_s = val_col[p2], inv[p2]
            prev_x = torch.cat([x_s[:1], x_s[:-1]])
            # valid rows are contiguous from each group's start, so a valid
            # row's predecessor (within the group) is valid too
            new_val = ~inv_s & (is_start | (valid & (x_s != prev_x)))
        else:
            p2 = lexsort_permutation([dropped] + keys + [col])
            x_s = col[p2]
            prev_x = torch.cat([x_s[:1], x_s[:-1]])
            new_val = is_start | (valid & (x_s != prev_x))
        slot_of[ai] = len(end_arrays)
        end_arrays.append(torch.cumsum(new_val, 0, dtype=torch.int32))

    # QUANTILE(x, q) / MEDIAN: one auxiliary sort per column with x as an
    # extra trailing KEY; the q-quantile (PERCENTILE_CONT linear
    # interpolation) sits at valid-local positions lo = ⌊(n-1)q⌋ and
    # hi = ⌈(n-1)q⌉ within the group — exactly those rows contribute
    # weighted values to a per-group segmented SUM (kernel B), evaluated at
    # the shared segment ends.
    def _run_total(x_int: Tensor) -> Tensor:
        """Per-row total of x over the row's group run (scatter-free
        forward/backward fills)."""
        cum = torch.cumsum(x_int, 0, dtype=torch.int32)
        excl = cum - x_int
        base = running_max(torch.where(is_start, excl, 0))
        big = torch.full((), n + 1, dtype=torch.int32, device=dev)
        aoa = running_min(torch.where(is_start, excl, big), reverse=True)
        nxt = torch.minimum(torch.cat([aoa[1:], big[None]]), cum[-1])
        return nxt - base

    for ai, (col, op) in enumerate(agg_cols):
        if not str(op).startswith("quantile@"):
            continue
        q = float(str(op).split("@", 1)[1])
        if isinstance(col, tuple):
            val_col, valid_col = col
            inv = valid_col == 0
            p2 = lexsort_permutation([dropped] + keys + [inv, val_col])
            x_s, inv_s = val_col[p2], inv[p2]
            row_ok = valid & ~inv_s
        else:
            p2 = lexsort_permutation([dropped] + keys + [col])
            x_s = col[p2]
            row_ok = valid
        gstart = running_max(torch.where(is_start, idx, 0))
        glen = _run_total(row_ok.to(torch.int32))
        p = idx - gstart                     # valid rows are group-leading
        pos_f = (glen - 1).to(torch.float32) * q
        lo = torch.floor(pos_f).to(torch.int32)
        hi = lo + (pos_f > lo.to(torch.float32)).to(torch.int32)
        frac = pos_f - lo.to(torch.float32)
        xf = x_s.to(torch.float32)
        z = torch.where(row_ok & (p == lo), xf * (1.0 - frac), 0.0)
        z = z + torch.where(row_ok & (p == hi) & (hi != lo), xf * frac, 0.0)
        sid_q = torch.where(valid, sid, 1 << 30)
        slot_of[ai] = len(end_arrays)
        end_arrays.append(flat_segscan("add", sid_q, [z], 0.0)[0])

    pos_slot = -1
    if need_pos:
        pos_slot = len(end_arrays)
        end_arrays.append(idx)

    # ONE shared compaction: pack segment-end rows (keys + every scan result)
    # to the front, in key order (kernel A).
    packed, _cnt = compact_arrays(
        sorted_keys + end_arrays, is_end,
        torch.full((), n, dtype=torch.int32, device=dev),
    )
    packed_keys = packed[:nk]
    packed_vals = packed[nk:]

    live_out = idx < n_groups
    keys_out = []
    for j in range(nk):
        k = packed_keys[j]
        if u32_key_order:
            k = u32_order_key(k)        # involution: restore original values
        keys_out.append(torch.where(live_out, k, 0).to(orig_dtypes[j]))

    def _prev(arr: Tensor, first) -> Tensor:
        return torch.cat([arr.new_full((1,), first), arr[:-1]])

    counts_out = None
    if need_pos:
        P = packed_vals[pos_slot]
        counts_out = P - _prev(P, -1)

    outs: List[Tensor] = []
    for ai, ((col, op), (kind, cum_j)) in enumerate(zip(agg_cols, plans)):
        if kind == "count":
            outs.append(torch.where(live_out, counts_out, 0).to(torch.int32))
        elif kind == "countd":
            E = packed_vals[slot_of[ai]]
            r = E - _prev(E, 0)
            outs.append(torch.where(live_out, r, 0).to(torch.int32))
        elif kind == "quantile":
            r = packed_vals[slot_of[ai]]     # per-group segmented sum
            outs.append(torch.where(live_out, r, 0.0).to(torch.float32))
        elif kind == "telescope":
            E = packed_vals[cum_base + cum_j]
            r = E - _prev(E, 0)
            outs.append(torch.where(live_out, r, 0).to(col.dtype))
        else:
            r = packed_vals[slot_of[ai]]
            ne = agg_neutral(op, r.dtype)
            outs.append(torch.where(live_out, r, ne).to(col.dtype))
    return keys_out, outs, n_groups


def groupby_batch(
    batch: ColumnBatch,
    key_names: Union[str, Sequence[str]],
    aggs: Sequence[Tuple[str, str, str]],
    mask: Optional[Tensor] = None,
    u32_key_order: bool = False,
) -> ColumnBatch:
    """GROUP BY over a batch. ``aggs`` = (source column, op, output name).

    Output columns: keys first (under their own names), then aggregates in
    order — the reference's layout (``groupby.fut:45-48``: output col 0 is
    the key). ``mask`` fuses a WHERE predicate into the group-by's own sort.
    """
    if isinstance(key_names, str):
        key_names = [key_names]
    key_arrays = [batch.column(k) for k in key_names]
    agg_inputs = [
        (tuple(batch.column(s) for s in src) if isinstance(src, tuple)
         else batch.column(src), op)
        for src, op, _ in aggs
    ]
    keys_out, agg_outs, n_groups = groupby_aggregate(
        key_arrays, agg_inputs, batch.n_valid, mask=mask,
        u32_key_order=u32_key_order,
    )
    cols = dict(zip(key_names, keys_out))
    for (_, _, out_name), arr in zip(aggs, agg_outs):
        cols[out_name] = arr
    return ColumnBatch(cols, n_groups)
