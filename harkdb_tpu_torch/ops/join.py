"""Equi-join (counterpart of ``harkdb_tpu.ops.join``).

Ordering contract, kept from the JAX package: output sorted ascending by
key; within a key, left rows in original order, each paired with every
matching right row in original order; output columns = [left cols | right
cols]. Keys present on one side only emit nothing (inner join); LEFT JOIN
keeps unmatched left rows with zero-filled right columns (the hidden
matched flags mark them as NULL, plan/nulls.py).

The algorithm is the JAX package's, run on torch tensors:

  1. **Ranges** (:func:`compute_join_ranges`): both sides' keys
     concatenated, rights before lefts, and sorted ONCE by the key tuple
     with a stable sort (``ops.sort.lexsort_permutation``), so rights
     precede lefts within every key run. Per sorted-left row, the match
     count is the rights of its run and the first match ``lo`` the rights
     before its run. Only the tagged original row index rides the sort, as
     the radix sort's int32 value where the keys are integers packing into
     one order word (whose runs are then the key runs): there the words,
     the run arithmetic and the per-side splits are
     ``kernels.join_runs``' two kernels on a card. Other keys take a
     cumsum, a running max (kernel B) and stable compactions (kernel A).
     The carried columns do not move here.
     Every join total comes out of this one pass; the planner reads the one
     it needs back to size the output (count-then-materialize).
  2. **Materialization** (:func:`join_batches` / :func:`join_indices`):
     the segments that emit rows are pre-compacted (kernel A), then
     ``kernels.expand.expand_fills`` (kernel D on a card) gives each output
     slot its segment and the segment's start, first match and match end.
     That names each slot's original left and right row (one index gather
     each), and every carried column moves once, by one gather from the
     caller's column at the output's size (late materialization).

Static shapes as in the JAX package: materialization takes
``out_capacity`` from the planner's count phase.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.kernels.expand import expand_fills
from harkdb_tpu_torch.kernels.join_runs import (
    ORIG_MASK, join_runs, join_tags, join_words, join_words_supported,
)
from harkdb_tpu_torch.kernels.radix_sort import sort_pairs
from harkdb_tpu_torch.ops.sort import (
    _pad_to_max, lexsort_permutation, one_integer_word, order_words,
)
from harkdb_tpu_torch.prims.compaction import compact_arrays
from harkdb_tpu_torch.prims.scan import running_max, running_min
from harkdb_tpu_torch.utils.metrics import count_join, span

Tensor = torch.Tensor


class JoinRanges(NamedTuple):
    """Single-pass join state, reused by count AND materialize phases.

    Arrays are in sorted coordinates: index i of the ``l_*`` arrays is the
    i-th live left row in (key, original-order) sorted order (first
    ``n_lefts`` entries live), likewise ``r_*`` for right rows. The carried
    columns stay the caller's, in original row order, and are read only
    where the output slots are known (:func:`join_batches`).
    """

    l_orig: Tensor         # (nl,) original left row per sorted-left position
    counts: Tensor         # (nl,) right matches (0 past live)
    lo: Tensor             # (nl,) first matching sorted-right position
    l_cols: Tuple[Tensor, ...]  # carried left columns, as passed (no copy)
    r_orig: Tensor         # (nr,) original right row per sorted-right pos
    r_cols: Tuple[Tensor, ...]  # carried right columns, as passed
    n_lefts: Tensor        # live left rows
    total: Tensor          # inner-join pair count
    total_left: Tensor     # LEFT-join row count (unmatched lefts emit 1)
    r_matched: object = None   # (nr,) bool: right row has a left match
    #                            (FULL-OUTER ranges only, need_full=True)
    total_full: object = None  # total_left + unmatched right rows
    total_approx: object = None  # float32 pair total — int32 wrap guard

    @property
    def l_payload(self) -> Tuple[Tensor, ...]:
        """The carried left columns in sorted-left order (the JAX package's
        field), gathered on each access; no query path reads it."""
        return _in_sorted_order(self.l_cols, self.l_orig)

    @property
    def r_payload(self) -> Tuple[Tensor, ...]:
        """The carried right columns in sorted-right order."""
        return _in_sorted_order(self.r_cols, self.r_orig)


def _in_sorted_order(cols: Sequence[Tensor], orig: Tensor
                     ) -> Tuple[Tensor, ...]:
    # Entries past a side's live count are unspecified: clamp them into
    # range so the gather reads a real row.
    if not cols:
        return ()
    idx = torch.clamp(orig, 0, cols[0].shape[0] - 1)
    return tuple(c.index_select(0, idx) for c in cols)


def _i32(v: int, device) -> Tensor:
    return torch.full((), v, dtype=torch.int32, device=device)


def _padded_keys(l_keys, n_l, r_keys, n_r, l_null, r_null) -> list:
    """Each key over rights then lefts, pads as the dtype max so they
    cluster at the back (rights before lefts, so the stable sort orders
    rights before lefts within every key run), and the NULL codes after the
    keys where either side has NULL flags."""
    keys = [
        torch.cat([_pad_to_max(rk, n_r), _pad_to_max(lk, n_l)])
        for lk, rk in zip(l_keys, r_keys)
    ]
    if l_null is not None or r_null is not None:
        # uint8 codes order as the JAX package's int32 ones and pack into
        # the key's sort word (8 bits instead of 32).
        dev = keys[0].device
        nl, nr = l_keys[0].shape[0], r_keys[0].shape[0]
        lnc = (l_null.to(torch.uint8) * 2 if l_null is not None
               else torch.zeros(nl, dtype=torch.uint8, device=dev))
        rnc = (r_null.to(torch.uint8) if r_null is not None
               else torch.zeros(nr, dtype=torch.uint8, device=dev))
        keys.append(torch.cat([rnc, lnc]))
    return keys


def compute_join_ranges(
    l_key, n_l: Tensor, r_key, n_r: Tensor,
    l_cols: Sequence[Tensor] = (), r_cols: Sequence[Tensor] = (),
    l_null: Optional[Tensor] = None, r_null: Optional[Tensor] = None,
    need_full: bool = False,
) -> JoinRanges:
    """One concat sort and the arithmetic of its key runs → everything a
    join needs.

    Integer keys that pack into one order word, without the FULL OUTER
    fields, take ``kernels.join_runs``: on a card one kernel before the
    sort (one int32 key a side) and one after it, on the CPU their plain
    versions. Any other join (float keys, several words, ``need_full``)
    takes the composition below: run starts per operand, kernel B's running
    max and kernel A's compactions on a card.

    ``l_cols``/``r_cols`` are the columns the join will carry. They are
    kept by reference, in original row order: neither the sort nor the
    compactions move them (:func:`join_batches` gathers each once).

    ``l_key``/``r_key`` may be single tensors or LISTS of equal-length key
    tensors (multi-key equi-join: rows match when every key is equal).

    ``l_null``/``r_null`` optionally mark rows whose key tuple is SQL NULL
    (NULL matches nothing, not even another NULL): one extra sort operand, a
    null code (0 = valid, 1 = null right, 2 = null left), splits null rows
    into their own runs — no sentinel key values.

    ``need_full=True`` additionally computes per-right-row match flags and
    the FULL-OUTER row total (a reversed cummin fills each run's left count
    back over its rights).
    """
    l_keys = list(l_key) if isinstance(l_key, (list, tuple)) else [l_key]
    r_keys = list(r_key) if isinstance(r_key, (list, tuple)) else [r_key]
    nl, nr = l_keys[0].shape[0], r_keys[0].shape[0]
    if nl >= (1 << 30) or nr >= (1 << 30):
        raise ValueError("row capacity >= 2^30")
    dev = l_keys[0].device
    n = nl + nr
    has_null = l_null is not None or r_null is not None
    key_dtypes = [torch.promote_types(lk.dtype, rk.dtype)
                  for lk, rk in zip(l_keys, r_keys)]
    one_word = one_integer_word(key_dtypes + [torch.uint8] * has_null)
    if one_word and not need_full:
        # The packing is a bijection: equal words are equal key tuples, so
        # the runs read off the sorted word and the tag rides the sort as
        # its value. kernels/join_runs does the rest: the words kernel
        # where the keys are one int32 a side, then the sort, then the runs
        # kernel (their plain versions on the CPU).
        if join_words_supported(l_keys, r_keys):
            word, bits, tag = join_words(l_keys[0], n_l, r_keys[0], n_r,
                                         l_null, r_null)
        else:
            (word, bits), = order_words(
                _padded_keys(l_keys, n_l, r_keys, n_r, l_null, r_null))
            tag = join_tags(nl, nr, n_l, n_r, dev)
        with span("hark.join.count.sort"):
            sword, stag = sort_pairs(word, bits, tag)
        runs = join_runs(sword, stag, nl, n_l)
        count_join(n, fused=dev.type == "cuda")
        return JoinRanges(
            runs.l_orig, runs.counts, runs.lo, tuple(l_cols), runs.r_orig,
            tuple(r_cols), runs.n_lefts, runs.total, runs.total_left,
            total_approx=runs.total_approx,
        )

    count_join(n, fused=False)
    keys = _padded_keys(l_keys, n_l, r_keys, n_r, l_null, r_null)
    orig_tagged = join_tags(nl, nr, n_l, n_r, dev)
    with span("hark.join.count.sort"):
        if one_word:
            sword, stag = lexsort_permutation(keys, orig_tagged)
        else:
            perm = lexsort_permutation(keys)
    if one_word:
        skeys = [sword]
    else:
        # Float keys (each NaN a run of its own) or several words: the run
        # starts per operand, gathered through the permutation.
        skeys = [k[perm] for k in keys]
        stag = orig_tagged[perm]
    zero = _i32(0, dev)
    l_idx = torch.arange(nl, dtype=torch.int32, device=dev)
    r_idx = torch.arange(nr, dtype=torch.int32, device=dev)
    # side code from the tag bits: 0 = live right, 1 = live left, else pad.
    side_code = (stag >> 30) & 3
    sorig = stag & ORIG_MASK

    pos = torch.arange(n, dtype=torch.int32, device=dev)
    is_right = (side_code == 0).to(torch.int32)
    is_left = side_code == 1

    # Key-run starts (any key operand changes — the null code counts too,
    # isolating null rows in matchless runs; NaN keys differ from
    # themselves, so each NaN row is a run of its own, as in the JAX
    # package); within-run inclusive right count via cumsum difference.
    run_start = pos == 0
    for skey in skeys:
        prev = torch.cat([skey[:1], skey[:-1]])
        run_start = run_start | (skey != prev)
    r_cum = torch.cumsum(is_right, 0, dtype=torch.int32)
    # Base = rights before this run = r_excl at my run's start; r_excl is
    # non-decreasing, so a running max over the run-start values fills it.
    r_excl = r_cum - is_right
    base = running_max(torch.where(run_start, r_excl, zero))
    rights_in_run_so_far = r_cum - base

    # For a LEFT row, every right of its run precedes it → its match count
    # is rights_in_run_so_far and its lo is base.
    counts_sorted = torch.where(is_left, rights_in_run_so_far, zero)
    total = counts_sorted.sum(dtype=torch.int32)
    total_left = torch.where(
        is_left, torch.clamp(counts_sorted, min=1), zero
    ).sum(dtype=torch.int32)
    # int32 overflow guard: a 65536² CROSS JOIN sums to exactly 2^32, so
    # total wraps to 0; the float32 total lets the planner raise instead.
    total_approx = counts_sorted.to(torch.float32).sum()

    r_matched_sorted = None
    total_full = None
    if need_full:
        # A right row is matched iff its run contains any live left. Lefts
        # follow rights within a run, so fill each run's TOTAL left count
        # backward: reversed cummin of per-run left-exclusive prefixes.
        il = is_left.to(torch.int32)
        l_cum = torch.cumsum(il, 0, dtype=torch.int32)
        l_excl = l_cum - il
        lbase = running_max(torch.where(run_start, l_excl, zero))
        big = _i32(n + 1, dev)
        at_or_after = running_min(torch.where(run_start, l_excl, big),
                                  reverse=True)
        nxt = torch.cat([at_or_after[1:], big.reshape(1)])
        nxt = torch.minimum(nxt, l_cum[-1])
        total_lefts_in_run = nxt - lbase
        r_matched_sorted = (is_right > 0) & (total_lefts_in_run > 0)
        n_r_unmatched = ((is_right > 0) & ~r_matched_sorted).sum(
            dtype=torch.int32)
        total_full = total_left + n_r_unmatched

    # Stable compactions back to per-side coordinates (kernel A on a card).
    # Rows past the live count are unspecified: counts drives expansion
    # sizes downstream, so zero its tail.
    nn = _i32(n, dev)
    l_split, n_lefts = compact_arrays(
        [sorig, counts_sorted, base], is_left, nn,
    )
    l_orig, cl, lo = (a[:nl] for a in l_split)
    counts = torch.where(l_idx < n_lefts, cl, zero)

    r_extra = [r_matched_sorted.to(torch.int32)] if need_full else []
    r_split, n_rights = compact_arrays(
        [sorig] + r_extra, is_right > 0, nn,
    )
    r_orig = r_split[0][:nr]
    r_matched = None
    if need_full:
        r_matched = torch.where(
            r_idx < n_rights, r_split[1][:nr] > 0,
            torch.ones((), dtype=torch.bool, device=dev),
        )               # pads count as "matched" (never appended)

    return JoinRanges(
        l_orig, counts, lo, tuple(l_cols), r_orig, tuple(r_cols),
        n_lefts, total, total_left, r_matched, total_full, total_approx,
    )


def join_match_count(
    l_key, n_l: Tensor, r_key, n_r: Tensor, kind: str = "inner",
    l_null: Optional[Tensor] = None, r_null: Optional[Tensor] = None,
) -> Tensor:
    """Exact number of output rows (device scalar) — the count phase.

    LEFT JOIN emits one row for every unmatched left row, so its count is
    ``sum(max(matches, 1))`` over live left rows; FULL OUTER additionally
    counts unmatched right rows.
    """
    rng = compute_join_ranges(
        l_key, n_l, r_key, n_r, l_null=l_null, r_null=r_null,
        need_full=kind == "full",
    )
    if kind == "left":
        return rng.total_left
    if kind == "full":
        return rng.total_full
    return rng.total


def _pair_slots(rng: JoinRanges, out_capacity: int, kind: str):
    """Pair expansion: each output slot's original left and right row.

    Returns ``(l_row, r_row, live, matched, total)`` per output slot:
    ``l_row`` the original left row (0 where not ``live``), ``r_row`` the
    original right row (0 where not ``matched``), both int32, and flags;
    an inner join's slots are ``matched`` wherever they are ``live``.

    Empty-emit sources are pre-compacted (kernel A) with their original
    left row, then ``expand_fills`` (kernel D on a card) gives every slot
    its segment and that segment's ``offsets`` / ``lo`` / match-end fills.
    This is the JAX package's kernel path
    (``harkdb_tpu/ops/join.py:354-379``) and the port's only one; where the
    JAX package carries the value columns through it, the port carries the
    row index and leaves the columns to the caller.
    """
    counts, n_lefts = rng.counts, rng.n_lefts
    nl, nr = counts.shape[0], rng.r_orig.shape[0]
    dev = counts.device
    zero = _i32(0, dev)
    l_idx = torch.arange(nl, dtype=torch.int32, device=dev)
    if kind in ("left", "full"):
        # FULL OUTER's left-preserving part IS a left join; the unmatched
        # right rows append after it (join_batches).
        emit = torch.where(l_idx < n_lefts, torch.clamp(counts, min=1), zero)
        total = rng.total_left
    elif kind == "inner":
        emit = counts
        total = rng.total
    else:
        raise ValueError(f"Unsupported join kind {kind!r}")
    out_idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)

    packed, n_src = compact_arrays(
        [emit, rng.lo, counts, rng.l_orig], emit > 0, _i32(nl, dev),
    )
    p_emit = torch.where(l_idx < n_src, packed[0], zero)
    p_lo, p_counts, p_orig = packed[1:]
    offsets = torch.cumsum(p_emit, 0, dtype=torch.int32) - p_emit
    rend = p_lo + p_counts            # first sorted-right slot past the
    #                                   segment's matches — monotone
    seg, off_f, (lo_f, rend_f) = expand_fills(
        offsets, n_src, out_capacity, (p_lo, rend),
    )
    live = out_idx < total
    r_pos = lo_f + (out_idx - off_f)
    matched = live & (r_pos < rend_f)
    # Entries past the packed and split counts are unspecified (kernel A),
    # so clamp every index into range and zero the rows of dead slots.
    l_row = torch.where(
        live, p_orig.index_select(0, torch.clamp(seg, 0, nl - 1)), zero)
    r_row = torch.where(
        matched, rng.r_orig.index_select(0, torch.clamp(r_pos, 0, nr - 1)),
        zero)
    return l_row, r_row, live, matched, total


def _masked(keep: Tensor, col: Tensor) -> Tensor:
    """``col`` where ``keep``, else 0 of the column's dtype."""
    return torch.where(keep, col, torch.zeros((), dtype=col.dtype,
                                              device=col.device))


def join_indices(
    l_key: Tensor, n_l: Tensor, r_key: Tensor, n_r: Tensor,
    out_capacity: int, kind: str = "inner",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Materialize pair indices ``(l_idx, r_idx, matched, total)`` padded to
    capacity.

    ``l_idx``/``r_idx`` index the *original* (unsorted) rows of each side.
    ``matched`` is False on LEFT-JOIN rows with no right match. Entries past
    ``total`` point at row 0. If ``total > out_capacity`` the result is
    truncated — the planner sizes capacity from :func:`join_match_count`.
    """
    rng = compute_join_ranges(l_key, n_l, r_key, n_r)
    l_row, r_row, _live, matched, total = _pair_slots(rng, out_capacity, kind)
    return l_row, r_row, matched, total


def inner_join_indices(
    l_key: Tensor, n_l: Tensor, r_key: Tensor, n_r: Tensor,
    out_capacity: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Inner-join pair indices ``(l_idx, r_idx, total)`` (see join_indices)."""
    l_idx, r_idx, _, total = join_indices(
        l_key, n_l, r_key, n_r, out_capacity, "inner"
    )
    return l_idx, r_idx, total


def join_batches(
    left: Optional[ColumnBatch],
    right: Optional[ColumnBatch],
    l_key_name,
    r_key_name,
    out_capacity: int,
    l_out: Optional[Dict[str, str]] = None,
    r_out: Optional[Dict[str, str]] = None,
    kind: str = "inner",
    ranges: Optional[JoinRanges] = None,
    matched_out: Optional[str] = None,
    l_matched_out: Optional[str] = None,
    l_null: Optional[Tensor] = None,
    r_null: Optional[Tensor] = None,
) -> ColumnBatch:
    """Equi-join of two batches (inner, left, or full outer; RIGHT JOIN is
    the planner's operand swap of LEFT).

    ``l_out``/``r_out`` map source column → output name (projection +
    rename, defaulting to all columns under their own names). Output column
    order is [left cols | right cols]. Outer joins fill the missing side's
    columns with 0 and mark the rows via the hidden flag columns (NULL
    model — plan/nulls.py).

    ``ranges`` optionally supplies a precomputed :func:`compute_join_ranges`
    result WITH matching carried columns (l_out/r_out keys order) — the
    planner passes the count phase's ranges so the concat sort runs once
    per join; ``left``/``right`` may then be None but ``l_out``/``r_out``
    must be given explicitly. FULL OUTER requires ranges computed with
    ``need_full=True``.

    ``matched_out`` optionally names an extra int32 0/1 output column: 1
    where the RIGHT side is present (0 on left-preserved no-match rows).
    ``l_matched_out`` (FULL OUTER) likewise marks LEFT-side presence (0
    only on the appended unmatched right rows).
    """
    if ranges is None:
        l_out = l_out if l_out is not None else {n: n for n in left.names}
        r_out = r_out if r_out is not None else {n: n for n in right.names}
        l_keys = ([l_key_name] if isinstance(l_key_name, str)
                  else list(l_key_name))
        r_keys = ([r_key_name] if isinstance(r_key_name, str)
                  else list(r_key_name))
        ranges = compute_join_ranges(
            [left.column(k) for k in l_keys], left.n_valid,
            [right.column(k) for k in r_keys], right.n_valid,
            l_cols=[left.column(s) for s in l_out],
            r_cols=[right.column(s) for s in r_out],
            l_null=l_null, r_null=r_null,
            need_full=kind == "full",
        )
    elif l_out is None or r_out is None:
        raise ValueError(
            "join_batches: explicit l_out/r_out are required when a "
            "precomputed ranges is supplied (its payload column order is "
            "defined by them)"
        )
    l_row, r_row, live, matched, total = _pair_slots(
        ranges, out_capacity, kind)

    # Late materialization: each carried column moves once, from the
    # caller's column at the output's size. index_select reads the int32
    # rows as they are (``col[rows]`` would widen them per column).
    with span("hark.join.fill.gather"):
        cols = {dst: _masked(live, col.index_select(0, l_row))
                for dst, col in zip(l_out.values(), ranges.l_cols)}
        for dst, col in zip(r_out.values(), ranges.r_cols):
            cols[dst] = _masked(matched, col.index_select(0, r_row))
    if matched_out is not None:
        cols[matched_out] = matched.to(torch.int32)

    if kind == "full":
        # Append the unmatched right rows after the left-preserving part:
        # compact their original rows (kernel A on a card), then blend by
        # output position — the appended block starts at the left part's
        # total.
        if ranges.r_matched is None:
            raise ValueError(
                "FULL OUTER join requires ranges computed with "
                "need_full=True"
            )
        dev = live.device
        nr = ranges.r_orig.shape[0]
        (um_orig,), _n_um = compact_arrays(
            [ranges.r_orig], ~ranges.r_matched, _i32(nr, dev),
        )
        total_full = ranges.total_full
        out_idx = torch.arange(out_capacity, dtype=torch.int32, device=dev)
        app = (out_idx >= total) & (out_idx < total_full)
        j = torch.clamp(out_idx - total, 0, nr - 1)
        a_row = torch.where(app, um_orig.index_select(0, j), _i32(0, dev))
        with span("hark.join.fill.gather"):
            for dst, col in zip(r_out.values(), ranges.r_cols):
                cols[dst] = torch.where(app, col.index_select(0, a_row),
                                        cols[dst])
            for dst in l_out.values():
                cols[dst] = _masked(~app, cols[dst])
        one = _i32(1, dev)
        if matched_out is not None:
            cols[matched_out] = torch.where(app, one, cols[matched_out])
        if l_matched_out is not None:
            cols[l_matched_out] = (
                (out_idx < total_full) & ~app
            ).to(torch.int32)
        return ColumnBatch(cols, total_full)

    if l_matched_out is not None:
        cols[l_matched_out] = live.to(torch.int32)
    return ColumnBatch(cols, total)
