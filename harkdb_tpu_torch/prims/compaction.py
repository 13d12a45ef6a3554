"""Masked compaction of batches and column lists (kernel A's callers).

Counterpart of ``harkdb_tpu.prims.compaction`` (``compact_indices``,
``compact``, ``compact_batch``, ``compact_arrays``). All go through
``kernels.compact.flat_compact``, which launches the CUDA kernel for CUDA
tensors and takes its plain version for CPU tensors. The kernel moves
32-bit words, so columns of other types travel as words here: 1- and
2-byte types widen to int32, 8-byte types split into two words, and each
is restored afterwards.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.kernels.compact import (
    flat_compact, flat_compact_supported,
)


def _to_words(col: torch.Tensor
              ) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]],
                                                      torch.Tensor]]:
    """32-bit word columns carrying ``col`` + the function restoring it."""
    dt = col.dtype
    if flat_compact_supported({"c": col}):
        return [col], lambda ws: ws[0]
    size = col.element_size()
    if size == 4:
        return [col.view(torch.int32)], lambda ws: ws[0].view(dt)
    if size == 8:
        pair = col.contiguous().view(torch.int32).view(-1, 2)
        return ([pair[:, 0].contiguous(), pair[:, 1].contiguous()],
                lambda ws: torch.stack(ws, 1).view(dt).view(-1))
    return [col.to(torch.int32)], lambda ws: ws[0].to(dt)


def _count(n_valid, n: int, device) -> torch.Tensor:
    """``n_valid`` (None for all ``n`` rows, an int or a tensor) as a 0-d
    int32 tensor on ``device``, filled there: a host value copied to the
    card would wait for the card's queue."""
    if isinstance(n_valid, torch.Tensor):
        return n_valid.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), n if n_valid is None else n_valid,
                      dtype=torch.int32, device=device)


def compact_indices(mask: torch.Tensor,
                    n_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of set mask positions (below ``n_valid``), packed to the
    front: kernel A over an iota column. Returns ``(indices, count)``;
    entries past ``count`` equal the capacity (an out-of-bounds sentinel,
    as in ``harkdb_tpu/prims/compaction.py:22``)."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    out, count = flat_compact({"i": idx}, mask,
                              _count(n_valid, n, mask.device))
    return torch.where(idx < count, out["i"], n), count


def compact(values: torch.Tensor, mask: torch.Tensor, n_valid=None,
            fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact one array by ``mask`` (rows below ``n_valid``, all rows if
    None): ``(packed, count)``, with ``fill`` past ``count``
    (``harkdb_tpu/prims/compaction.py:41``)."""
    n = values.shape[0]
    dev = values.device
    (packed,), count = compact_arrays([values], mask,
                                      _count(n_valid, n, dev))
    live = torch.arange(n, dtype=torch.int32, device=dev) < count
    return torch.where(live, packed, torch.full((), fill, dtype=packed.dtype,
                                                device=dev)), count


def compact_arrays(arrays: Sequence[torch.Tensor], mask: torch.Tensor,
                   n_valid: torch.Tensor
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pack rows of several equal-length arrays where ``mask`` holds (and
    the row index is below ``n_valid``) to the front, in order.

    Returns ``(packed_list, count)``; rows at index >= count are
    unspecified and zero-suppressed by callers.
    """
    words, restores = [], []
    for a in arrays:
        ws, restore = _to_words(a)
        restores.append((len(words), len(ws), restore))
        words.extend(ws)
    out, count = flat_compact(
        {str(i): w for i, w in enumerate(words)}, mask, n_valid
    )
    packed = [
        restore([out[str(i)] for i in range(start, start + k)])
        for start, k, restore in restores
    ]
    return packed, count


def compact_batch(batch: ColumnBatch, mask: torch.Tensor) -> ColumnBatch:
    """Filter a ColumnBatch by a boolean mask over its rows.

    Output keeps the input capacity (filter can only shrink); surviving
    rows are packed to the front in original order (stable — required for
    parity with reference row-order preservation). Bool columns come out
    as int32 0/1, as the JAX package's compaction returns them.
    """
    names = batch.names
    packed, count = compact_arrays(
        [batch.columns[c] for c in names], mask, batch.n_valid
    )
    packed = [p.to(torch.int32) if p.dtype == torch.bool else p
              for p in packed]
    return ColumnBatch(dict(zip(names, packed)), count)
