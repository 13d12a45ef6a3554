"""Kernel A: stable stream compaction (``csrc/compact.cu``).

Counterpart of ``harkdb_tpu/kernels/compact.py`` (``flat_compact``, the
log-shift Pallas kernel). Same contract: rows where ``mask`` holds and the
row index is below ``n_valid`` are packed to the front, in order, across
several 4-byte columns; outputs keep the input capacity and rows at index
>= ``count`` are unspecified.

``flat_compact`` launches the CUDA kernel for CUDA tensors and raises on
anything it does not take. ``flat_compact_reference`` is the plain PyTorch
version of the same contract; it serves CPU tensors (the tests) and is the
baseline the kernel is compared and timed against on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harkdb_tpu_torch.kernels import _lib

#: Number of kernel launches ``flat_compact`` made in this process: one per
#: call, and one more for each further group of 32 columns.
LAUNCHES = 0

_COLS_PER_LAUNCH = 32

_WORD_DTYPES = (torch.int32, torch.float32)


def flat_compact_supported(cols: Dict[str, torch.Tensor]) -> bool:
    """Whether kernel A moves every column of ``cols``: int32 or float32.
    The JAX package's predicate takes uint32 too; the ingest gives tables
    int32 and float32 columns, so no uint32 column reaches the kernel in
    either."""
    return all(c.dtype in _WORD_DTYPES for c in cols.values())


def _check_inputs(cols: Dict[str, torch.Tensor], mask: torch.Tensor,
                  n_valid: torch.Tensor) -> None:
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a 1-D bool tensor, got "
                         f"{mask.dtype} of shape {tuple(mask.shape)}")
    if n_valid.dim() != 0 or n_valid.dtype != torch.int32:
        raise ValueError("n_valid must be a 0-d int32 tensor")
    n = mask.shape[0]
    for name, c in cols.items():
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"column {name!r} has shape {tuple(c.shape)}, "
                             f"expected ({n},)")
        if not flat_compact_supported({name: c}):
            raise ValueError(f"column {name!r} has dtype {c.dtype}; the "
                             f"kernel moves int32/float32 words only")


def flat_compact(cols: Dict[str, torch.Tensor], mask: torch.Tensor,
                 n_valid: torch.Tensor
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Pack rows where ``mask & (idx < n_valid)`` holds to the front.

    Returns ``(cols_out, count)`` with ``count`` a 0-d int32 tensor on the
    columns' device. CPU tensors take :func:`flat_compact_reference`; CUDA
    tensors launch the one-pass kernel (no host synchronisation) or raise.
    """
    _check_inputs(cols, mask, n_valid)
    dev = mask.device
    if any(t.device != dev for t in (n_valid, *cols.values())):
        raise ValueError("mask, n_valid and the columns must share a device")
    if dev.type == "cpu":
        return flat_compact_reference(cols, mask, n_valid)
    if dev.type != "cuda":
        raise ValueError(f"flat_compact runs on CUDA or CPU, not {dev}")
    global LAUNCHES
    lib = _lib.library()
    n = mask.shape[0]
    names = list(cols)
    ins = [cols[k].contiguous().view(torch.int32) for k in names]
    outs = [torch.empty_like(t) for t in ins]
    mask = mask.contiguous()
    n_valid = n_valid.contiguous()
    tiles = lib.harkdb_compact_num_tiles(n)
    if tiles == 0:
        return ({k: o.view(cols[k].dtype) for k, o in zip(names, outs)},
                torch.zeros((), dtype=torch.int32, device=dev))
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.zeros(1 + tiles, dtype=torch.int64, device=dev)
    groups = max(1, -(-len(ins) // _COLS_PER_LAUNCH))
    offsets = (torch.empty(tiles, dtype=torch.int32, device=dev)
               if groups > 1 else None)
    in_ptrs, out_ptrs = _lib.pointer_array(ins), _lib.pointer_array(outs)
    _lib.check(lib.harkdb_compact(
        mask.data_ptr(), n_valid.data_ptr(), n, len(ins), in_ptrs, out_ptrs,
        count.data_ptr(), scratch.data_ptr(),
        None if offsets is None else offsets.data_ptr(),
        _lib.stream_handle(dev),
    ), "compact kernel")
    LAUNCHES += groups
    out = {k: o.view(cols[k].dtype) for k, o in zip(names, outs)}
    return out, count


def flat_compact_reference(cols: Dict[str, torch.Tensor], mask: torch.Tensor,
                           n_valid: torch.Tensor
                           ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`flat_compact`: the same packed rows
    and count; rows past ``count`` are zero. ``nonzero`` makes it wait for
    the device, so the main path never takes it on a card."""
    _check_inputs(cols, mask, n_valid)
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    keep = mask & (idx < n_valid)
    rows = torch.nonzero(keep).squeeze(1)
    out = {}
    for name, c in cols.items():
        o = torch.zeros_like(c)
        o[: rows.shape[0]] = c[rows]
        out[name] = o
    return out, keep.sum(dtype=torch.int32)
