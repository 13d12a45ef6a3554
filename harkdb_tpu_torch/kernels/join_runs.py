"""Kernels E: the join's count phase on each side of the pair sort
(``csrc/join_runs.cu``).

No TPU kernel of the JAX package does this: its count phase
(``harkdb_tpu/ops/join.py``, ``compute_join_ranges``) is a composition of
XLA operations. The port's card path replaces the same composition by two
kernels around the pair sort (``kernels.radix_sort.sort_pairs``):

* :func:`join_words`, before the sort: one int32 key a side (and optional
  NULL flags) become the concatenated order word and the tagged row index,
  rights first, then lefts. A tag is the row within its side, with
  ``LEFT_BIT`` on lefts and ``PAD_BIT`` on rows at or past their side's
  ``n_valid``; a pad's key reads as ``INT32_MAX``. The word is
  ``ops.sort.order_words`` of those padded keys, bit for bit: the key with
  its sign bit flipped (32 bits), or ``code | (key + 2^31) << 8`` with NULL
  codes (40 bits; 1 on a NULL right, 2 on a NULL left).
* :func:`join_runs`, after the sort: a key run starts where the sorted word
  changes. Each live left's ``counts`` is the live rights of its run and
  its ``lo`` the live rights before its run; lefts land at their rank among
  the sorted live lefts (``l_orig``, ``counts``, ``lo``), rights at theirs
  (``r_orig``); ``counts`` is 0 from the live lefts on, ``l_orig``, ``lo``
  and ``r_orig`` are unspecified there. ``total`` and ``total_left`` (each
  left counted at least once) are int32 sums that wrap, ``total_approx``
  the float32 total, ``n_lefts`` the live lefts.

Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version for CPU tensors. The plain versions are the port's
composition that the kernels replace, so the CPU computes what it computed
before; on the card they are the baseline the kernels are held and timed
against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from harkdb_tpu_torch.kernels import _lib
from harkdb_tpu_torch.kernels.compact import flat_compact_reference

#: Launches of the words kernel and of the runs kernel in this process: one
#: per call on a CUDA tensor with rows.
WORDS_LAUNCHES = 0
RUNS_LAUNCHES = 0

LEFT_BIT = 1 << 30
PAD_BIT = -(1 << 31)               # bit 31 as int32
ORIG_MASK = (1 << 30) - 1
_I32_MAX = (1 << 31) - 1


class JoinRuns(NamedTuple):
    l_orig: torch.Tensor       # (nl,) original left row per sorted live left
    counts: torch.Tensor       # (nl,) live rights in its run (0 past live)
    lo: torch.Tensor           # (nl,) live rights before its run
    r_orig: torch.Tensor       # (nr,) original right row per sorted live right
    n_lefts: torch.Tensor      # 0-d int32: live lefts
    total: torch.Tensor        # 0-d int32: Σ counts, wrapping
    total_left: torch.Tensor   # 0-d int32: Σ max(counts, 1), wrapping
    total_approx: torch.Tensor  # 0-d float32: Σ counts


def _i32(v: int, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=device)


def join_tags(nl: int, nr: int, n_l, n_r, device) -> torch.Tensor:
    """The tagged row index of ``nr`` rights then ``nl`` lefts: each row
    within its side, ``LEFT_BIT`` on lefts, ``PAD_BIT`` at and past the
    side's live count ``n_l`` / ``n_r`` (0-d tensors or ints)."""
    l_idx = torch.arange(nl, dtype=torch.int32, device=device)
    r_idx = torch.arange(nr, dtype=torch.int32, device=device)
    zero, pad_bit = _i32(0, device), _i32(PAD_BIT, device)
    l_tag = (l_idx | LEFT_BIT) | torch.where(l_idx >= n_l, pad_bit, zero)
    r_tag = r_idx | torch.where(r_idx >= n_r, pad_bit, zero)
    return torch.cat([r_tag, l_tag])


def join_words_supported(l_keys, r_keys) -> bool:
    """Whether :func:`join_words` takes the keys: one int32 key a side."""
    return (len(l_keys) == 1 == len(r_keys)
            and l_keys[0].dtype == torch.int32 == r_keys[0].dtype)


def _check_words(l_key, r_key, l_null, r_null) -> None:
    for name, k in (("l_key", l_key), ("r_key", r_key)):
        if k.dim() != 1 or k.dtype != torch.int32:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{k.dtype} of shape {tuple(k.shape)}")
        if k.shape[0] >= (1 << 30):
            raise ValueError("row capacity >= 2^30")
    for name, f, k in (("l_null", l_null, l_key), ("r_null", r_null, r_key)):
        if f is not None and (f.dtype != torch.bool or f.shape != k.shape):
            raise ValueError(f"{name} must be bool of shape "
                             f"{tuple(k.shape)}")
    devs = {t.device for t in (l_key, r_key, l_null, r_null) if t is not None}
    if len(devs) != 1:
        raise ValueError("keys and NULL flags must share a device")


def _live_count(v, device) -> torch.Tensor:
    """A side's live count as a 0-d int32 tensor on ``device``, made there
    (a host value copied to the card would wait for its queue)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(())
    return _i32(v, device)


def join_words(l_key: torch.Tensor, n_l, r_key: torch.Tensor, n_r,
               l_null: Optional[torch.Tensor] = None,
               r_null: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """``(word, bits, tag)`` over ``nr + nl`` rows, rights first: the
    order word of each row's padded key (and NULL code) and its tagged row
    index (module docstring). ``word`` is int32 over 32 bits, or int64 over
    40 where either side has NULL flags. A CUDA tensor launches the words
    kernel (``n_l`` / ``n_r`` read on the card: no sync); a CPU tensor
    takes :func:`join_words_reference`."""
    _check_words(l_key, r_key, l_null, r_null)
    dev = l_key.device
    if dev.type == "cpu":
        return join_words_reference(l_key, n_l, r_key, n_r, l_null, r_null)
    if dev.type != "cuda":
        raise ValueError(f"join_words runs on CUDA or CPU, not {dev}")
    global WORDS_LAUNCHES
    nl, nr = l_key.shape[0], r_key.shape[0]
    wide = l_null is not None or r_null is not None
    word = torch.empty(nl + nr, dtype=torch.int64 if wide else torch.int32,
                       device=dev)
    tag = torch.empty(nl + nr, dtype=torch.int32, device=dev)
    if nl + nr:
        l_key, r_key = l_key.contiguous(), r_key.contiguous()
        nulls = [None if f is None else f.contiguous().view(torch.uint8)
                 for f in (l_null, r_null)]
        counts = [_live_count(v, dev) for v in (n_l, n_r)]
        lib = _lib.library()
        _lib.check(lib.harkdb_join_words(
            l_key.data_ptr(), r_key.data_ptr(),
            *[None if f is None else f.data_ptr() for f in nulls],
            counts[0].data_ptr(), counts[1].data_ptr(), nl, nr, int(wide),
            word.data_ptr(), tag.data_ptr(), _lib.stream_handle(dev),
        ), "join words kernel")
        WORDS_LAUNCHES += 1
    return word, 40 if wide else 32, tag


def join_words_reference(l_key: torch.Tensor, n_l, r_key: torch.Tensor, n_r,
                         l_null: Optional[torch.Tensor] = None,
                         r_null: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Plain PyTorch version of :func:`join_words`: the port's composition
    of padded keys, NULL codes, order bits and tags."""
    _check_words(l_key, r_key, l_null, r_null)
    nl, nr = l_key.shape[0], r_key.shape[0]
    dev = l_key.device
    hi = _i32(_I32_MAX, dev)
    l_idx = torch.arange(nl, dtype=torch.int32, device=dev)
    r_idx = torch.arange(nr, dtype=torch.int32, device=dev)
    key = torch.cat([torch.where(r_idx < n_r, r_key, hi),
                     torch.where(l_idx < n_l, l_key, hi)])
    tag = join_tags(nl, nr, n_l, n_r, dev)
    if l_null is None and r_null is None:
        return key ^ torch.iinfo(torch.int32).min, 32, tag
    lnc = (l_null.to(torch.uint8) * 2 if l_null is not None
           else torch.zeros(nl, dtype=torch.uint8, device=dev))
    rnc = (r_null.to(torch.uint8) if r_null is not None
           else torch.zeros(nr, dtype=torch.uint8, device=dev))
    code = torch.cat([rnc, lnc]).to(torch.int64)
    return code | ((key.to(torch.int64) + (1 << 31)) << 8), 40, tag


def _check_runs(sword, stag, nl) -> None:
    if sword.dim() != 1 or sword.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"sword must be a 1-D int32 or int64 tensor, got "
                         f"{sword.dtype} of shape {tuple(sword.shape)}")
    if stag.dtype != torch.int32 or stag.shape != sword.shape:
        raise ValueError(f"stag must be int32 of shape "
                         f"{tuple(sword.shape)}")
    if stag.device != sword.device:
        raise ValueError("sword and stag must share a device")
    if not 0 <= nl <= sword.shape[0]:
        raise ValueError(f"nl {nl} outside [0, {sword.shape[0]}]")


def join_runs(sword: torch.Tensor, stag: torch.Tensor, nl: int, n_l
              ) -> JoinRuns:
    """The count phase's ranges and totals from the sorted word and tag of
    ``nl`` left rows and ``len(sword) - nl`` right rows (module
    docstring); ``n_l`` is the live lefts the tags were made with. A CUDA
    tensor launches the runs kernel (no sync); a CPU tensor takes
    :func:`join_runs_reference`."""
    _check_runs(sword, stag, nl)
    dev = sword.device
    if dev.type == "cpu":
        return join_runs_reference(sword, stag, nl, n_l)
    if dev.type != "cuda":
        raise ValueError(f"join_runs runs on CUDA or CPU, not {dev}")
    global RUNS_LAUNCHES
    n = sword.shape[0]
    l_orig, counts, lo = (torch.empty(nl, dtype=torch.int32, device=dev)
                          for _ in range(3))
    r_orig = torch.empty(n - nl, dtype=torch.int32, device=dev)
    # total, total_left, total_approx's bits, n_lefts: the kernel writes
    # all four
    totals = (torch.empty if n else torch.zeros)(4, dtype=torch.int32,
                                                 device=dev)
    if n:
        lib = _lib.library()
        sword, stag = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                       else t.clone() for t in (sword, stag))
        live = _live_count(n_l, dev)
        scratch = torch.zeros(lib.harkdb_join_runs_scratch_words(n),
                              dtype=torch.int64, device=dev)
        _lib.check(lib.harkdb_join_runs(
            sword.data_ptr(), sword.element_size(), stag.data_ptr(), n, nl,
            live.data_ptr(), scratch.data_ptr(), l_orig.data_ptr(),
            counts.data_ptr(), lo.data_ptr(), r_orig.data_ptr(),
            totals.data_ptr(), _lib.stream_handle(dev),
        ), "join runs kernel")
        RUNS_LAUNCHES += 1
    return JoinRuns(l_orig, counts, lo, r_orig, totals[3], totals[0],
                    totals[1], totals.view(torch.float32)[2])


def join_runs_reference(sword: torch.Tensor, stag: torch.Tensor, nl: int,
                        n_l) -> JoinRuns:
    """Plain PyTorch version of :func:`join_runs`: the port's composition
    (run starts off the word, a cumsum of the rights, a running max for
    each run's base, two stable compactions); ``n_lefts`` and the counts'
    zeros come from the tags, so ``n_l`` is not read. ``l_orig``, ``lo``
    and ``r_orig`` are 0 past their live rows."""
    _check_runs(sword, stag, nl)
    n = sword.shape[0]
    dev = sword.device
    zero = _i32(0, dev)
    # side code from the tag bits: 0 = live right, 1 = live left, else pad.
    side_code = (stag >> 30) & 3
    sorig = stag & ORIG_MASK
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    is_right = (side_code == 0).to(torch.int32)
    is_left = side_code == 1
    # Key-run starts (the null code counts too, isolating null rows in
    # matchless runs); within-run inclusive right count via cumsum
    # difference.
    prev = torch.cat([sword[:1], sword[:-1]])
    run_start = (pos == 0) | (sword != prev)
    r_cum = torch.cumsum(is_right, 0, dtype=torch.int32)
    # Base = rights before this run = r_excl at my run's start; r_excl is
    # non-decreasing, so a running max over the run-start values fills it.
    r_excl = r_cum - is_right
    base = torch.cummax(torch.where(run_start, r_excl, zero), 0).values
    # For a LEFT row, every right of its run precedes it → its match count
    # is the rights of its run so far and its lo is base.
    counts_sorted = torch.where(is_left, r_cum - base, zero)
    total = counts_sorted.sum(dtype=torch.int32)
    total_left = torch.where(
        is_left, torch.clamp(counts_sorted, min=1), zero
    ).sum(dtype=torch.int32)
    # int32 overflow guard: a 65536² CROSS JOIN sums to exactly 2^32, so
    # total wraps to 0; the float32 total lets the planner raise instead.
    total_approx = counts_sorted.to(torch.float32).sum()
    nn = _i32(n, dev)
    lefts, n_lefts = flat_compact_reference(
        {"orig": sorig, "count": counts_sorted, "base": base}, is_left, nn)
    l_idx = torch.arange(nl, dtype=torch.int32, device=dev)
    counts = torch.where(l_idx < n_lefts, lefts["count"][:nl], zero)
    rights, _ = flat_compact_reference({"orig": sorig}, is_right > 0, nn)
    return JoinRuns(lefts["orig"][:nl], counts, lefts["base"][:nl],
                    rights["orig"][:n - nl], n_lefts, total, total_left,
                    total_approx)
