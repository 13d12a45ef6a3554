"""Kernel C: dense-key GROUP BY sums and counts (``csrc/dense_agg.cu``).

Counterpart of ``harkdb_tpu/kernels/matmul_agg.py`` (``onehot_groupby_sums``,
the one-hot matmul Pallas kernel); the module keeps its name so a reader
finds the counterpart, but on the card this is a shared-memory histogram
with int32 atomics, not a matmul: the base-256 bf16 digits existed for the
MXU.

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

from typing import List, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.kernels import _lib

#: Number of times ``onehot_groupby_sums`` launched its kernel in this
#: process.
LAUNCHES = 0

KEY_TILE = 1024        # span padding granule (the planner's _pad_span)
MAX_KEY_SPAN = 16384   # the dense path's gate, as in the JAX package
MAX_SUM_COLS = 32      # sum columns one launch carries (csrc/dense_agg.cu)


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
    global LAUNCHES
    lib = _lib.library()
    n_cols = len(value_cols)
    group = min(lib.harkdb_dense_agg_max_group(span), n_cols + 1)
    if group < 1:
        raise ValueError(f"span {span} does not fit one block's shared "
                         f"memory")
    key = key.contiguous()
    vals = [c.contiguous() for c in value_cols]
    mask_c = mask.contiguous() if mask is not None else None
    n_valid = n_valid.contiguous()
    out = torch.zeros((n_cols + 1, span), dtype=torch.int32, device=dev)
    ptrs = _lib.pointer_array(vals)
    _lib.check(lib.harkdb_dense_agg(
        key.data_ptr(), mask_c.data_ptr() if mask_c is not None else None,
        n_valid.data_ptr(), key.shape[0], key_min, span, n_cols, ptrs, group,
        out.data_ptr(), _lib.stream_handle(dev),
    ), "dense aggregation kernel")
    LAUNCHES += 1
    return out[n_cols], list(out[:n_cols].unbind(0)), _keys_axis(
        key, key_min, span)


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
