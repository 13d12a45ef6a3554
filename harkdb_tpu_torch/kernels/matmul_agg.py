"""Kernel C: dense-key GROUP BY sums and counts (``csrc/dense_agg.cu``).

Counterpart of ``harkdb_tpu/kernels/matmul_agg.py`` (``onehot_groupby_sums``,
the one-hot matmul Pallas kernel); the module keeps its name so a reader
finds the counterpart, but on the card this is a histogram in the shared
memory of a thread block cluster, with warp-aggregated int32 atomics, not a
matmul: the base-256 bf16 digits existed for the MXU. :func:`dense_agg_plan`
picks the histogram's shape from the span and the column count.

Same contract: for keys in ``[key_min, key_min + span)``, ``counts[k]`` and
``sums[c][k]`` aggregate the rows with ``key == key_min + k`` that are below
``n_valid`` and pass ``mask``; sums are exact int32, mod 2^32, bit-identical
to the sort path. ``keys_axis = key_min + arange(span)`` in the key's dtype.
``key_min`` is a Python int on the host (from table statistics or the
planner's one probe).

``onehot_groupby_sums`` launches the CUDA kernel for CUDA tensors and raises
on anything it does not take. ``onehot_groupby_sums_reference`` is the plain
PyTorch version (int64 ``index_add_`` over the rebased keys, wrapped to
int32); it serves CPU tensors (the tests) and is the baseline the kernel is
compared and timed against on the card.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.kernels import _lib

#: Number of times ``onehot_groupby_sums`` launched its kernel in this
#: process.
LAUNCHES = 0

KEY_TILE = 1024        # span padding granule (pad_span)
MAX_KEY_SPAN = 16384   # the dense path's gate, as in the JAX package
MAX_SUM_COLS = 32      # sum columns one launch carries (csrc/dense_agg.cu)
#: Shared memory a CTA of 1024 threads spends beside its histogram: two
#: stages of 36 bytes a thread for its rows (csrc/dense_agg.cu), or in shape
#: (c) two stages of keys and mask plus two of traded keys, the same 72 KB.
STAGE_BYTES = 1024 * 36 * 2
MAX_CLUSTER = 8        # CTAs of a cluster (the portable maximum)
#: CTAs of a cluster when every CTA keeps the whole histogram.
REPLICATED_CLUSTER = 8
#: The histogram's shapes (csrc/dense_agg.cu): (a) a copy per CTA, (b) the
#: key range split over the cluster, (c) the columns split over a pair.
REPLICATED, SPLIT_KEYS, SPLIT_COLUMNS = 0, 1, 2
COLUMN_PAIR_COLS = 4   # columns, the count included, shape (c) takes


def pad_span(span: int) -> int:
    """Round a key span up to the dense path's key-tile granule."""
    return -(-span // KEY_TILE) * KEY_TILE


def shape_plan(shape: int, cluster: int, span: int, n_cols: int,
               smem_optin: int) -> Optional[Tuple[int, int, int, int]]:
    """The plan of histogram ``shape`` over ``cluster`` CTAs for ``span``
    keys and ``n_cols`` sum columns (plus the count), or None where the
    shape does not fit the shared memory one CTA may opt in to. A plan is
    ``(shape, cluster, key_shift, shared_cols)``: ``SPLIT_KEYS`` gives each
    CTA ``1 << key_shift`` keys (a power of two) of the first ``shared_cols``
    columns, the rest going straight to the output; ``SPLIT_COLUMNS`` is
    always a pair of CTAs."""
    c1 = n_cols + 1
    budget = smem_optin - STAGE_BYTES
    if shape == REPLICATED:
        return (REPLICATED, cluster, 0, c1) if 4 * c1 * span <= budget else None
    if shape == SPLIT_COLUMNS:
        fits = c1 <= COLUMN_PAIR_COLS and 8 * span <= budget
        return (SPLIT_COLUMNS, 2, 0, 2) if fits else None
    shift = max(0, (-(-span // cluster) - 1).bit_length())
    return SPLIT_KEYS, cluster, shift, min(c1, budget // (4 << shift))


def dense_agg_plan(span: int, n_cols: int,
                   smem_optin: int) -> Tuple[int, int, int, int]:
    """The histogram's shape for ``span`` keys and ``n_cols`` sum columns
    (plus the count), given the shared memory one CTA may opt in to: the
    first of these that fits (:func:`shape_plan`):

    * ``REPLICATED`` over ``REPLICATED_CLUSTER`` CTAs, when the whole
      histogram fits a CTA beside its row staging: each CTA keeps a copy,
      updated with local shared atomics;
    * ``SPLIT_COLUMNS``, at most ``COLUMN_PAIR_COLS`` columns of which two
      fit a CTA: each CTA of a pair keeps two columns, and the pair trades
      its rows' keys, so every update stays local;
    * ``SPLIT_KEYS`` over 2, 4 or 8 CTAs, the smallest cluster whose key
      slice of every column fits; failing that, 8 CTAs with only some
      columns in shared memory. An update that crosses to another CTA costs
      several times a local one, so fewer CTAs are better.
    """
    for shape, cluster in ((REPLICATED, REPLICATED_CLUSTER),
                           (SPLIT_COLUMNS, 2)):
        plan = shape_plan(shape, cluster, span, n_cols, smem_optin)
        if plan is not None:
            return plan
    cluster = 2
    while True:
        plan = shape_plan(SPLIT_KEYS, cluster, span, n_cols, smem_optin)
        if plan[3] == n_cols + 1 or cluster == MAX_CLUSTER:
            return plan
        cluster *= 2


@functools.lru_cache(maxsize=None)
def smem_optin() -> int:
    """Shared memory one CTA may opt in to (bytes), asked of the card once."""
    return _lib.library().harkdb_smem_optin()


def matmul_agg_applicable(ops: Sequence[str], key_span: int) -> bool:
    return key_span <= MAX_KEY_SPAN and all(
        op in ("sum", "count") for op in ops
    )


def _check_inputs(key, value_cols, n_valid, key_min, span, mask) -> None:
    if key.dim() != 1 or key.dtype != torch.int32:
        raise ValueError("key must be a 1-D int32 tensor")
    n = key.shape[0]
    if n_valid.dim() != 0 or n_valid.dtype != torch.int32:
        raise ValueError("n_valid must be a 0-d int32 tensor")
    if isinstance(key_min, bool) or not isinstance(key_min, int):
        raise ValueError(f"key_min must be a Python int, got {key_min!r}")
    if not -(1 << 31) <= key_min < (1 << 31):
        raise ValueError(f"key_min {key_min} does not fit int32")
    if not isinstance(span, int) or span < 1:
        raise ValueError(f"span must be a positive int, got {span!r}")
    if len(value_cols) > MAX_SUM_COLS:
        raise ValueError(f"at most {MAX_SUM_COLS} sum columns, got "
                         f"{len(value_cols)}")
    for c in value_cols:
        if c.dim() != 1 or c.dtype != torch.int32 or c.shape[0] != n:
            raise ValueError(f"value column of {c.dtype} and shape "
                             f"{tuple(c.shape)}; expected int32 ({n},)")
    if mask is not None and (mask.dim() != 1 or mask.dtype != torch.bool
                             or mask.shape[0] != n):
        raise ValueError(f"mask must be a ({n},) bool tensor")
    dev = key.device
    others = [n_valid, *value_cols] + ([mask] if mask is not None else [])
    if any(t.device != dev for t in others):
        raise ValueError("key, n_valid, values and mask must share a device")


def _keys_axis(key: torch.Tensor, key_min: int, span: int) -> torch.Tensor:
    return torch.arange(span, dtype=key.dtype, device=key.device) + key_min


def onehot_groupby_sums(
    key: torch.Tensor,
    value_cols: Sequence[torch.Tensor],
    n_valid: torch.Tensor,
    key_min: int,
    span: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """Dense-key group-by sums (see the module docstring).

    Returns ``(counts, sums, keys_axis)``: ``counts`` and each of ``sums``
    are ``(span,)`` int32. CPU tensors take
    :func:`onehot_groupby_sums_reference`; CUDA tensors launch the kernel
    (no host synchronisation) or raise.
    """
    value_cols = list(value_cols)
    _check_inputs(key, value_cols, n_valid, key_min, span, mask)
    dev = key.device
    if dev.type == "cpu":
        return onehot_groupby_sums_reference(key, value_cols, n_valid,
                                             key_min, span, mask)
    if dev.type != "cuda":
        raise ValueError(f"onehot_groupby_sums runs on CUDA or CPU, not {dev}")
    plan = dense_agg_plan(span, len(value_cols), smem_optin())
    return _launch(key, value_cols, n_valid, key_min, span, mask, plan)


def _launch(key, value_cols, n_valid, key_min, span, mask, plan):
    """One launch of the kernel under ``plan`` (see :func:`dense_agg_plan`)."""
    global LAUNCHES
    lib = _lib.library()
    shape, cluster, key_shift, shared_cols = plan
    dev = key.device
    n_cols = len(value_cols)
    key = key.contiguous()
    vals = [c.contiguous() for c in value_cols]
    mask_c = mask.contiguous() if mask is not None else None
    n_valid = n_valid.contiguous()
    out = torch.zeros((n_cols + 1, span), dtype=torch.int32, device=dev)
    keys_axis = torch.empty(span, dtype=torch.int32, device=dev)
    ptrs = _lib.pointer_array(vals)
    _lib.check(lib.harkdb_dense_agg(
        key.data_ptr(), mask_c.data_ptr() if mask_c is not None else None,
        n_valid.data_ptr(), key.shape[0], key_min, span, n_cols, ptrs,
        shape, cluster, key_shift, shared_cols, out.data_ptr(),
        keys_axis.data_ptr(), _lib.stream_handle(dev),
    ), "dense aggregation kernel")
    LAUNCHES += 1
    return out[n_cols], list(out[:n_cols].unbind(0)), keys_axis


def onehot_groupby_sums_reference(
    key: torch.Tensor,
    value_cols: Sequence[torch.Tensor],
    n_valid: torch.Tensor,
    key_min: int,
    span: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`onehot_groupby_sums`: int64
    ``index_add_`` over the rebased keys, wrapped to int32. The rebase
    ``key - key_min`` wraps mod 2^32 as the TPU wrapper's int32
    subtraction does."""
    value_cols = list(value_cols)
    _check_inputs(key, value_cols, n_valid, key_min, span, mask)
    dev = key.device
    n = key.shape[0]
    valid = torch.arange(n, dtype=torch.int32, device=dev) < n_valid
    if mask is not None:
        valid = valid & mask
    k = (key.to(torch.int64) - key_min).to(torch.int32)
    valid = valid & (k >= 0) & (k < span)
    slot = torch.where(valid, k, torch.zeros_like(k)).to(torch.int64)
    live = valid.to(torch.int64)

    def dense(weights: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(span, dtype=torch.int64, device=dev)
        return acc.index_add_(0, slot, weights * live).to(torch.int32)

    counts = dense(torch.ones(n, dtype=torch.int64, device=dev))
    sums = [dense(c.to(torch.int64)) for c in value_cols]
    return counts, sums, _keys_axis(key, key_min, span)
