"""Window functions — counterpart of ``harkdb_tpu.plan.windows``.

Same evaluation plan as the JAX package, one stable payload sort per
distinct (PARTITION BY, ORDER BY) shape plus one shared restore step:

  * every shape's partition/order key arrays and argument columns are
    evaluated up front in original row order and ride the chain of sorts
    as payload;
  * shape k sorts from whatever order shape k-1 left the data in (one
    ``lexsort_permutation`` over its key slots, then a gather of every
    state array), computes its outputs with position arithmetic and
    segmented scans in its own sorted order, and passes them along;
  * the carried original position is a permutation, so one
    inverse-permutation scatter restores batch order for ALL shapes.

Per-function logic: row_number / rank / dense_rank via running-max-filled
starts (``prims.scan``, kernel B on a card); running aggregates as
inclusive segmented scans (``kernels.segscan.agg_segscan``, kernel B on a
card); the SQL default RANGE frame (peers included) broadcasts each
tie-run's last scanned value by a gather at the run's end, found with a
reversed running min; lag/lead as ROWS-based shifts with a
validity-isolated partition-id guard; bounded ROWS-frame min/max from
log-shift windows.

Kept from the JAX package, faults included: window aggregates ignore the
NULL validity of their argument.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.kernels.segscan import agg_neutral, agg_segscan
from harkdb_tpu_torch.ops.sort import (
    descending_transform, lexsort_permutation,
)
from harkdb_tpu_torch.plan.errors import PlanError
from harkdb_tpu_torch.plan.expr import eval_expr
from harkdb_tpu_torch.prims.scan import running_max, running_min
from harkdb_tpu_torch.sql.ast_nodes import Col
from harkdb_tpu_torch.utils.metrics import window

_SCAN = {"sum": torch.add, "prod": torch.mul,
         "max": torch.maximum, "min": torch.minimum}
_BIG = 1 << 30


def validity_names(specs) -> List[str]:
    """Hidden ``#winvalid*`` output columns ``compute_windows`` emits for
    the given specs: NTH_VALUE (frame shorter than n ⇒ NULL) and any
    empty-capable ROWS frame (start after the partition slice's end)."""
    out = []
    for s in specs:
        frame = s[7] if len(s) > 7 else None
        need = s[1] == "nth_value" or (
            frame is not None
            and ((frame[1] is not None and frame[1] > 0)
                 or (frame[2] is not None and frame[2] < 0))
        )
        if need:
            out.append("#winvalid" + s[0][4:])
    return out


def run_first(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """``x`` at the first row of each row's run. Runs begin where
    ``starts`` holds; rows before the first start belong to a run that
    begins at row 0. The take-first segmented scan of the JAX package, as
    one gather."""
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    first = running_max(torch.where(starts, idx, 0))
    return x[first.long()]


def run_last(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """``x`` at the last row of each row's run (runs as in
    :func:`run_first`): the reversed take-first segmented scan of the JAX
    package, as one gather at the row before the next run's start."""
    n = x.shape[0]
    if n == 0:
        return x
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    nxt = running_min(torch.where(starts, idx, n), reverse=True)
    end = torch.cat([nxt[1:], nxt.new_full((1,), n)]) - 1
    return x[end.long()]


def restore_order(origpos: torch.Tensor,
                  arrays: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Put rows back at their original positions: ``origpos`` is the
    permutation the sort chain left (``origpos[i]`` = original row of
    sorted row i), so one scatter per array inverts it."""
    dst = origpos.long()
    out = []
    for a in arrays:
        r = torch.empty_like(a)
        r[dst] = a
        out.append(r)
    return out


def compute_windows(plan, batch: ColumnBatch,
                    specs: Sequence[Tuple] = None,
                    allow_skip_restore: bool = False):
    """Compute window outputs for ``plan.window_specs`` (or the given
    subset) over ``batch``; returns ``(batch + one column per spec,
    presorted)``. Runs inside the span ``hark.window``, which counts the
    batch's rows.

    ``allow_skip_restore``: when the plan detected that the query's final
    ORDER BY exactly matches one shape's (PARTITION BY, ORDER BY) sort
    (``plan.window_skip_shape``), that shape is processed LAST, every
    batch column rides the sort chain, and BOTH the restore step and the
    caller's ORDER BY sort are skipped (``presorted=True``). Distributed
    callers pass False: the executor's distributed sort restores the
    order of each rank's rows."""
    with window(batch.capacity):
        return _compute_windows(plan, batch, specs, allow_skip_restore)


def _compute_windows(plan, batch: ColumnBatch, specs, allow_skip_restore):
    cap = batch.capacity
    dev = batch.device
    cols = dict(batch.columns)
    pos0 = torch.arange(cap, dtype=torch.int32, device=dev)
    live = pos0 < batch.n_valid
    dropped = (~live).to(torch.int32)
    count = live.sum(dtype=torch.int32)

    groups: Dict[tuple, List[tuple]] = {}
    for spec in (plan.window_specs if specs is None else specs):
        _out, _f, _arg, parts, oexprs, descs, *_rest = spec
        groups.setdefault((parts, oexprs, descs), []).append(spec)

    skip_shape = (plan.window_skip_shape
                  if allow_skip_restore and plan.window_skip_shape in groups
                  else None)
    if skip_shape is not None:
        # the matching shape must run last (its sort is the final order)
        reordered = {k: v for k, v in groups.items() if k != skip_shape}
        reordered[skip_shape] = groups[skip_shape]
        groups = reordered

    # Tie-break on the original position; grouped queries tie-break on the
    # exec group keys (unique per row) instead, as the JAX package does.
    if getattr(plan, "grouped", False) and plan.group_keys:
        rid_names = [k for k in plan.group_exec_keys if k in cols]
    else:
        rid_names = [n for n in batch.names if n.startswith("#rid.")]

    # ---- evaluate every shape's keys/args once, in original order --------
    # ``state`` holds every array that must survive the sort chain, keyed
    # symbolically. Plain columns share one slot across shapes; derived
    # expressions get a per-shape slot.
    state: Dict[object, torch.Tensor] = {
        "#dropped": dropped,
        "#origpos": pos0,
    }
    for n in rid_names:
        state[f"col:{n}"] = cols[n]
    if not rid_names:
        state["#tie"] = pos0
    if skip_shape is not None:
        # every batch column must end up in the final (shape-sorted) order
        for n in batch.names:
            state.setdefault(f"col:{n}", cols[n])

    def _slot(gi: int, tag: str, j: int, expr):
        """Register an array for (group gi, role tag, position j); share
        slots for plain column references."""
        if isinstance(expr, str):                      # partition column name
            key = f"col:{expr}"
            if key not in state:
                state[key] = cols[expr]
            return key
        if isinstance(expr, Col):
            key = f"col:{expr.name}"
            if key not in state:
                state[key] = cols[expr.name]
            return key
        key = (gi, tag, j)
        state[key] = eval_expr(expr, cols, cap, plan.config)
        return key

    plans = []        # (gspecs, part_keys, order_keys, arg_slot)
    for gi, ((parts, oexprs, descs), gspecs) in enumerate(groups.items()):
        part_keys = [_slot(gi, "p", j, p) for j, p in enumerate(parts)]
        order_keys = []
        for j, (oe, d) in enumerate(zip(oexprs, descs)):
            if d:
                # The descending transform is order-reversing but not
                # value-preserving; keep a dedicated slot.
                a = eval_expr(oe, cols, cap, plan.config)
                key = (gi, "od", j)
                state[key] = descending_transform(a)
                order_keys.append(key)
            else:
                order_keys.append(_slot(gi, "o", j, oe))
        arg_slot: Dict[int, object] = {}
        for si, (_o, func, arg, *_r) in enumerate(gspecs):
            if arg is None or func in ("row_number", "rank", "dense_rank",
                                       "count", "ntile", "percent_rank",
                                       "cume_dist"):
                continue
            arg_slot[si] = _slot(gi, "a", si, arg)
        plans.append((gspecs, part_keys, order_keys, arg_slot))

    tie_keys = ([f"col:{n}" for n in rid_names] if rid_names else ["#tie"])

    def resort(key_names: List[object]):
        """Stable sort of the whole state by the named keys: one
        permutation, then a gather of every array."""
        perm = lexsort_permutation([state[k] for k in key_names])
        for k in list(state):
            state[k] = state[k][perm]

    idx = pos0                              # positions in current order
    valid = idx < count
    pad_start = idx == count                # padding rows form one run

    def prev_of(k):
        return torch.cat([k[:1], k[:-1]])

    out_keys: List[Tuple[str, object]] = []     # (out_name, state key)
    for gi, (gspecs, part_keys, order_keys, arg_slot) in enumerate(plans):
        sort_keys = ["#dropped"] + part_keys + order_keys + tie_keys
        # Dedupe (a partition column may also be a tie key) keeping order.
        sort_keys = list(dict.fromkeys(sort_keys))
        resort(sort_keys)
        s_part = [state[k] for k in part_keys]
        s_order = [state[k] for k in order_keys]

        p_changed = torch.zeros(cap, dtype=torch.bool, device=dev)
        for k in s_part:
            p_changed = p_changed | (k != prev_of(k))
        o_changed = p_changed
        for k in s_order:
            o_changed = o_changed | (k != prev_of(k))
        is_pstart = valid & ((idx == 0) | p_changed)
        is_tstart = valid & ((idx == 0) | o_changed)

        start = running_max(torch.where(is_pstart, idx, 0))
        pos = idx - start                       # 0-based in partition
        sid_p = torch.cumsum(is_pstart, 0, dtype=torch.int32) - 1
        # Padding rows would otherwise extend the last live run and leak
        # garbage backward through the peer broadcast — isolate them.
        t_starts = is_tstart | pad_start
        p_starts = is_pstart | pad_start
        safe_part = torch.where(valid, sid_p, _BIG)

        def peers_last(S):
            """Each tie-run's LAST value over the whole run (the SQL
            default RANGE frame includes peers)."""
            return run_last(S, t_starts)

        def part_last(S):
            """Each PARTITION's last value over the whole partition."""
            return run_last(S, p_starts)

        _plen_memo: List = []

        def get_plen():
            """Partition row count per row (computed once per shape)."""
            if not _plen_memo:
                _plen_memo.append(part_last(pos) + 1)
            return _plen_memo[0]

        def pscan(opname, x):
            return agg_segscan(opname, sid_p, [x])[0]

        # ---- explicit ROWS frames ----------------------------------------
        ssid_w = torch.where(valid, sid_p, -7)

        def shift_prev(a, s, fill):
            if s <= 0:
                return a
            s = min(s, cap)
            return torch.cat([torch.full((s,), fill, dtype=a.dtype,
                                         device=dev), a[:cap - s]])

        def shift_next(a, s, fill):
            if s <= 0:
                return a
            s = min(s, cap)
            return torch.cat([a[s:], torch.full((s,), fill, dtype=a.dtype,
                                                device=dev)])

        def shift_rel(a, d, fill):
            """a[i + d] (global shift; callers clamp partition crossings
            via plen-based selects — partitions are contiguous)."""
            if d == 0:
                return a
            return (shift_next(a, d, fill) if d > 0
                    else shift_prev(a, -d, fill))

        def trailing_window(opname, x, sid, keep, L):
            """min/max over the last L rows within the partition: log2(L)
            doubling passes build partition-clamped pow2 windows, then two
            overlapping windows cover L (idempotent ops)."""
            ne = agg_neutral(opname, x.dtype)
            op = _SCAN[opname]
            m = torch.where(keep, x, ne)
            w = 1
            while w * 2 <= L:
                sh = shift_prev(m, w, ne)
                sid_sh = shift_prev(sid, w, -9)
                m = op(m, torch.where(sid_sh == sid, sh, ne))
                w *= 2
            rem = L - w
            if rem:
                sh = shift_prev(m, rem, ne)
                sid_sh = shift_prev(sid, rem, -9)
                m = op(m, torch.where(sid_sh == sid, sh, ne))
            return m

        def sliding_minmax(opname, x, L):
            return trailing_window(opname, x, ssid_w, valid, L)

        def leading_minmax(opname, x, L):
            """min/max over the NEXT L rows (current row included) within
            the partition: the trailing window over reversed arrays."""
            def flip(a):
                return torch.flip(a, [0])

            return flip(trailing_window(opname, flip(x), flip(ssid_w),
                                        flip(valid), L))

        def frame_outputs(func, si, lo, hi):
            """General ROWS frame [pos+lo, pos+hi] (None = unbounded):
            counts from position arithmetic; sums/prods from the inclusive
            partition scan selected at constant relative shifts with
            partition-edge clamps; bounded min/max from trailing ∪ leading
            pow2 windows. Returns (value, n_in_frame)."""
            plen_ = get_plen()
            cstart = (torch.clamp(pos + lo, min=0) if lo is not None
                      else torch.zeros(cap, dtype=torch.int32, device=dev))
            cend = (torch.minimum(pos + hi, plen_ - 1) if hi is not None
                    else plen_ - 1)
            n_f = torch.clamp(cend - cstart + 1, min=0)
            if func == "count":
                return n_f, n_f
            x = state[arg_slot[si]]
            if func in ("sum", "avg", "prod"):
                op = "prod" if func == "prod" else "sum"
                xs = x.to(torch.float32) if func == "avg" else x
                PS = pscan(op, xs)
                total = part_last(PS)
                zero = 0 if op == "sum" else 1
                if hi is None:
                    hi_val = total
                else:
                    hv = shift_rel(PS, hi, zero)
                    hi_val = torch.where(pos + hi >= plen_, total, hv)
                    hi_val = torch.where(pos + hi < 0, zero, hi_val)
                if lo is None:
                    lo_excl = zero
                else:
                    lv = shift_rel(PS, lo - 1, zero)
                    lo_excl = torch.where(pos + lo - 1 < 0, zero, lv)
                    lo_excl = torch.where(pos + lo - 1 >= plen_, total,
                                          lo_excl)
                if func == "prod":
                    # planner guarantees lo is None (no inverse)
                    val = hi_val
                elif func == "avg":
                    val = (hi_val - lo_excl) / torch.clamp(
                        n_f.to(torch.float32), min=1.0
                    )
                else:
                    val = hi_val - lo_excl
                return val, n_f
            # min / max
            if lo is None and hi is None:
                return part_last(pscan(func, x)), n_f
            if lo is None:
                PS = pscan(func, x)
                ne = agg_neutral(func, x.dtype)
                total = part_last(PS)
                hv = shift_rel(PS, hi, ne)
                val = torch.where(pos + hi >= plen_, total, hv)
                val = torch.where(pos + hi < 0, ne, val)
                return val, n_f
            assert hi is not None   # [lo, ∞) min/max handled by the caller
            # both bounded: caller enforces lo <= 0 <= hi
            t = sliding_minmax(func, x, min(1 - lo, cap))
            ld = leading_minmax(func, x, min(hi + 1, cap))
            return _SCAN[func](t, ld), n_f

        for si, (out_name, func, _arg, *_rest) in enumerate(gspecs):
            params = gspecs[si][6]
            frame = gspecs[si][7] if len(gspecs[si]) > 7 else None
            if frame is not None:
                # frame = ("rows", lo, hi): signed offsets from the
                # current row, None = unbounded (parser). Positional,
                # peers excluded.
                lo, hi = frame[1], frame[2]
                if func in ("min", "max") and not (
                    (lo is None or lo <= 0) and (hi is None or hi >= 0)
                ):
                    raise PlanError(
                        "Bounded MIN/MAX frames must include the current "
                        "row (no inverse for the sliding combine)"
                    )
                if func in ("min", "max") and lo is not None and hi is None:
                    # [pos+lo, partition end] (lo ≤ 0): SUFFIX scan —
                    # reversed segmented scan over reversed partition ids
                    # (non-decreasing after the flip, so kernel B takes
                    # it) — selected at the constant shift `lo`, clamped
                    # to the partition start (where the whole-partition
                    # value = the suffix at the first row applies).
                    x = state[arg_slot[si]]
                    ne = agg_neutral(func, x.dtype)
                    rev_sid = torch.flip(_BIG - safe_part, [0])
                    sfx = torch.flip(agg_segscan(
                        func, rev_sid,
                        [torch.flip(torch.where(valid, x, ne), [0])],
                    )[0], [0])               # sfx[i] = op over [i, pend]
                    sv = shift_rel(sfx, lo, ne)
                    part_first_sfx = run_first(sfx, p_starts)
                    o = torch.where(pos + lo < 0, part_first_sfx, sv)
                    n_f = get_plen() - torch.clamp(pos + lo, min=0)
                else:
                    o, n_f = frame_outputs(func, si, lo, hi)
                key = ("out", out_name)
                state[key] = o
                out_keys.append((out_name, key))
                if (lo is not None and lo > 0) or (
                    hi is not None and hi < 0
                ):
                    # empty-capable frame: hidden validity column (0 ⇔
                    # the frame contains no rows → SQL NULL) drives the
                    # output NULL indicators (planner agg_null_flags)
                    vkey = ("out", "#winvalid" + out_name[4:])
                    state[vkey] = (n_f > 0).to(torch.int32)
                    out_keys.append(("#winvalid" + out_name[4:], vkey))
                continue
            if func == "row_number":
                o = pos + 1
            elif func == "rank":
                tstart_idx = running_max(torch.where(is_tstart, idx, 0))
                o = tstart_idx - start + 1
            elif func == "dense_rank":
                g = torch.cumsum(is_tstart, 0, dtype=torch.int32)
                gp = running_max(torch.where(is_pstart, g, 0))
                o = g - gp + 1
            elif func == "ntile":
                # SQL NTILE(n): the first plen%n buckets get one extra row
                nb = int(params[0])
                plen_ = get_plen()
                q, r = plen_ // nb, plen_ % nb
                big = r * (q + 1)           # rows covered by the big buckets
                o = torch.where(
                    pos < big,
                    pos // torch.clamp(q + 1, min=1),
                    r + (pos - big) // torch.clamp(q, min=1),
                ) + 1
            elif func == "percent_rank":
                tstart_idx = running_max(torch.where(is_tstart, idx, 0))
                rk = (tstart_idx - start).to(torch.float32)   # rank - 1
                plen_ = get_plen().to(torch.float32)
                o = torch.where(
                    plen_ > 1.0, rk / torch.clamp(plen_ - 1.0, min=1.0), 0.0
                )
            elif func == "cume_dist":
                plen_ = get_plen().to(torch.float32)
                o = (peers_last(pos + 1).to(torch.float32)
                     / torch.clamp(plen_, min=1.0))
            elif func == "nth_value":
                # value at partition-local position n-1 (the SQL default
                # frame reaches the last PEER, so rows whose frame is
                # shorter than n are NULL — hidden #winvalid indicator)
                x = state[arg_slot[si]]
                nn = int(params[0])
                z = torch.where(valid & (pos == nn - 1), x,
                                torch.zeros((), dtype=x.dtype, device=dev))
                o = part_last(pscan("sum", z))   # exactly one contributor
                vkey = ("out", "#winvalid" + out_name[4:])
                state[vkey] = (peers_last(pos) >= nn - 1).to(torch.int32)
                out_keys.append(("#winvalid" + out_name[4:], vkey))
            elif func in ("lag", "lead"):
                # ROWS-based (position, not peers) per the standard;
                # partition edges fill with the default (0 when omitted).
                x = state[arg_slot[si]]
                off = min(int(params[0]) if params else 1, cap)
                dflt = torch.tensor(params[1] if len(params) > 1 else 0,
                                    device=dev).to(x.dtype)
                fill = dflt.expand(off)
                # Validity-isolated sid: padding rows inherit the last live
                # partition's sid_p, so a raw sid_p comparison would let
                # lead() on the last live row match a padding neighbor.
                ssid = torch.where(valid, sid_p, -7)
                sfill = torch.full((off,), -8, dtype=torch.int32,
                                   device=dev)
                if func == "lag":
                    shifted = torch.cat([fill, x[:cap - off]])
                    nbr_sid = torch.cat([sfill, ssid[:cap - off]])
                else:
                    shifted = torch.cat([x[off:], fill])
                    nbr_sid = torch.cat([ssid[off:], sfill])
                o = torch.where(nbr_sid == ssid, shifted, dflt)
            elif func == "first_value":
                # each partition's first value (padding joins the last
                # partition, as the JAX package's take-first scan over
                # sid_p has it)
                o = run_first(state[arg_slot[si]], is_pstart)
            elif func == "last_value":
                # SQL default frame: the LAST PEER's value
                o = peers_last(state[arg_slot[si]])
            elif func == "count":
                o = peers_last(pos + 1)        # rows up to last peer
            elif func == "avg":
                x = state[arg_slot[si]]
                s = peers_last(pscan("sum", x.to(torch.float32)))
                c = peers_last(pos + 1).to(torch.float32)
                o = s / torch.clamp(c, min=1.0)
            else:                               # sum / prod / min / max
                x = state[arg_slot[si]]
                o = peers_last(pscan(func, x))
            key = ("out", out_name)
            state[key] = o
            out_keys.append((out_name, key))

        # This shape's private keys/args are dead weight for later sorts.
        for k in list(state):
            if isinstance(k, tuple) and len(k) == 3 and k[0] == gi:
                del state[k]
        # Shared column slots stay only while a later shape still needs
        # them (or they are tie keys / presorted-output columns).
        if skip_shape is None:
            needed = set(tie_keys)
            for _g2, pk2, ok2, as2 in plans[gi + 1:]:
                needed |= set(pk2) | set(ok2) | set(as2.values())
            for k in list(state):
                if (isinstance(k, str) and k.startswith("col:")
                        and k not in needed):
                    del state[k]

    if skip_shape is not None:
        # Presorted exit: the last shape's sort IS the query's final
        # ORDER BY — hand back every column in the current order, no
        # restore (the caller skips its ORDER BY sort too).
        out_cols = {n: state[f"col:{n}"] for n in batch.names}
        for out_name, k in out_keys:
            out_cols[out_name] = state[k]
        return ColumnBatch(out_cols, batch.n_valid), True

    # ---- ONE restore for every shape's outputs ---------------------------
    restored = restore_order(state["#origpos"],
                             [state[k] for _n, k in out_keys])
    for (out_name, _k), col in zip(out_keys, restored):
        cols[out_name] = col
    return ColumnBatch(cols, batch.n_valid), False
