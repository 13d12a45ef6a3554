"""Top-k selection with ``jax.lax.top_k``'s tie order.

The planner's ORDER BY + small LIMIT path (``plan/planner.py`` ``run_tail``)
picks the rows of the ``L`` largest values of a monotone int32 view of the
sort key (``ops.sort.ieee_order_view``) instead of sorting every row.
``lax.top_k`` is an XLA operation, not a Pallas kernel; its counterpart
here is one ``torch.topk`` call.

``lax.top_k`` breaks ties by the lowest index; ``torch.topk`` promises no
order among equal values. So the selection runs over a composite int64
that makes every value unique: the view in the high 32 bits, and
``2^31 - 1 - index`` in the low 32 (non-negative while the length is at
most 2^31), so of two equal views the lower index is the larger composite.
"""

from __future__ import annotations

import torch

_LOW = (1 << 31) - 1


def top_k_indices(view: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the ``k`` largest values of the 1-D int32 ``view``, in
    descending order of value, ties by the lowest position first
    (``jax.lax.top_k(view, k)[1]``). Returns an int64 tensor of ``k``
    positions on ``view``'s device."""
    n = view.shape[0]
    if view.dim() != 1 or view.dtype != torch.int32:
        raise ValueError(f"top_k_indices takes a 1-D int32 view, got "
                         f"{view.dtype} of shape {tuple(view.shape)}")
    if not 0 <= k <= n:
        raise ValueError(f"k={k} outside [0, {n}]")
    if n > _LOW + 1:
        raise ValueError(f"a view of {n} rows is longer than 2^31")
    idx = torch.arange(n, dtype=torch.int64, device=view.device)
    comp = view.to(torch.int64) * (1 << 32) + (_LOW - idx)
    return torch.topk(comp, k, sorted=True).indices


def top_k_indices_reference(view: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of :func:`top_k_indices` for the tests: a stable
    descending sort of the whole view, cut to ``k``."""
    return torch.sort(view, descending=True, stable=True).indices[:k]
