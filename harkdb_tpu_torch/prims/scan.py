"""Running max / min of a 1-D int32 tensor (``lax.cummax`` / ``lax.cummin``).

On a CUDA tensor these are kernel B's one-segment scan (``sid=None``, with
its ``reverse`` form): ``torch.cummax`` / ``torch.cummin`` give the same
values, but on a 1-D CUDA tensor they scan in one thread block (47 ms of
the 2^24-fact star join's 56 ms of device time on an H100). A CPU tensor
takes ``torch.cummax`` / ``torch.cummin``, the plain version.

``reverse=True`` scans from the last element to the first (the
flip / cummin / flip pattern): ``out[i]`` covers ``x[i:]``.
"""

from __future__ import annotations

import torch

from harkdb_tpu_torch.kernels.segscan import flat_segscan

_NEUTRAL = {"max": -(1 << 31), "min": (1 << 31) - 1}


def _running(op: str, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    if x.dim() != 1 or x.dtype != torch.int32:
        raise ValueError(f"running_{op} takes a 1-D int32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        scan = torch.cummax if op == "max" else torch.cummin
        if reverse:
            return torch.flip(scan(torch.flip(x, [0]), 0).values, [0])
        return scan(x, 0).values
    return flat_segscan(op, None, [x], _NEUTRAL[op], reverse=reverse)[0]


def running_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running maximum of ``x`` (from the end if ``reverse``)."""
    return _running("max", x, reverse)


def running_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running minimum of ``x`` (from the end if ``reverse``)."""
    return _running("min", x, reverse)
