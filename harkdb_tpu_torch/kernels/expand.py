"""Kernel D: segment expansion with per-segment fills (``csrc/expand.cu``).

Counterpart of ``harkdb_tpu/kernels/expand.py`` (``expand_fills``, the
log-shift dilation Pallas kernel). Same contract: ``offsets`` holds the
exclusive starts of ``n_src`` non-empty segments, strictly increasing over
the live entries; entries at index >= ``n_src`` are ignored. For every
output slot ``p < out_capacity``::

    seg_ids[p]      = max{i < n_src : offsets[i] <= p}   (0 if none)
    offsets_fill[p] = offsets[seg_ids[p]]
    extra_fills[e][p] = extra_values[e][seg_ids[p]]

Slots past the last segment's end keep the last segment's values; callers
mask with their own live predicate. The TPU kernel's max-fill needs every
extra plane to be non-negative and non-decreasing; the contract keeps that
precondition, though the kernel here does not rely on it (its max-scan runs
over segment indices, and the fills are gathers). Equal offsets (empty
segments, outside the contract) give the last of the equal entries in both
versions.

The kernel gives each block a tile of ``TILE`` output slots: one search for
the tile's source window, a marker scatter and a max-scan in shared memory,
then stores of 128 contiguous bytes a warp (``csrc/expand.cu``).

``expand_fills`` launches the CUDA kernel for CUDA tensors and raises on
anything it does not take. ``expand_fills_reference`` is the plain PyTorch
version (``torch.searchsorted`` + gathers); it serves CPU tensors (the
tests) and is the baseline the kernel is compared and timed against on the
card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from harkdb_tpu_torch.kernels import _lib

#: Number of times ``expand_fills`` launched its kernel in this process.
LAUNCHES = 0

MAX_EXTRAS = 8          # extra planes one launch carries (csrc/expand.cu)
#: Output slots a block owns: a mirror of ``kTile`` in csrc/expand.cu (2048
#: measured faster than 4096 on an H100, PERF.md), read by the edge cases.
TILE = 2048
_I32_MAX = 2147483647


def _check_inputs(offsets: torch.Tensor, n_src: torch.Tensor,
                  out_capacity: int,
                  extra_values: Sequence[torch.Tensor]) -> None:
    if offsets.dim() != 1 or offsets.dtype != torch.int32:
        raise ValueError("offsets must be a 1-D int32 tensor")
    if offsets.shape[0] == 0:
        raise ValueError("offsets must hold at least one entry")
    if n_src.dim() != 0 or n_src.dtype != torch.int32:
        raise ValueError("n_src must be a 0-d int32 tensor")
    if not isinstance(out_capacity, int) or out_capacity < 0:
        raise ValueError(f"out_capacity must be a non-negative int, got "
                         f"{out_capacity!r}")
    if len(extra_values) > MAX_EXTRAS:
        raise ValueError(f"at most {MAX_EXTRAS} extra planes, got "
                         f"{len(extra_values)}")
    for v in extra_values:
        if v.dim() != 1 or v.dtype != torch.int32 or v.shape != offsets.shape:
            raise ValueError(f"extra plane of {v.dtype} and shape "
                             f"{tuple(v.shape)}; expected int32 "
                             f"{tuple(offsets.shape)}")
    dev = offsets.device
    if any(t.device != dev for t in (n_src, *extra_values)):
        raise ValueError("offsets, n_src and the extra planes must share a "
                         "device")


def expand_fills(offsets: torch.Tensor, n_src: torch.Tensor,
                 out_capacity: int,
                 extra_values: Sequence[torch.Tensor] = (),
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Segment expansion with per-segment fills (see the module docstring).

    Returns ``(seg_ids, offsets_fill, extra_fills)``, each ``(out_capacity,)``
    int32. CPU tensors take :func:`expand_fills_reference`; CUDA tensors
    launch the kernel (no host synchronisation) or raise.
    """
    extra_values = list(extra_values)
    _check_inputs(offsets, n_src, out_capacity, extra_values)
    dev = offsets.device
    if dev.type == "cpu":
        return expand_fills_reference(offsets, n_src, out_capacity,
                                      extra_values)
    if dev.type != "cuda":
        raise ValueError(f"expand_fills runs on CUDA or CPU, not {dev}")
    global LAUNCHES
    lib = _lib.library()
    offsets = offsets.contiguous()
    n_src = n_src.contiguous()
    ins = [v.contiguous() for v in extra_values]
    seg = torch.empty(out_capacity, dtype=torch.int32, device=dev)
    off = torch.empty_like(seg)
    outs = [torch.empty_like(seg) for _ in ins]
    in_ptrs, out_ptrs = _lib.pointer_array(ins), _lib.pointer_array(outs)
    _lib.check(lib.harkdb_expand_fills(
        offsets.data_ptr(), n_src.data_ptr(), offsets.shape[0], out_capacity,
        len(ins), in_ptrs, out_ptrs, seg.data_ptr(), off.data_ptr(),
        _lib.stream_handle(dev),
    ), "expand kernel")
    LAUNCHES += 1
    return seg, off, outs


def expand_fills_reference(offsets: torch.Tensor, n_src: torch.Tensor,
                           out_capacity: int,
                           extra_values: Sequence[torch.Tensor] = (),
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      List[torch.Tensor]]:
    """Plain PyTorch version of :func:`expand_fills`: ``searchsorted`` of
    every slot into the live offsets (dead entries read as INT32_MAX, as
    the TPU wrapper's ``off_eff``), then one gather per plane."""
    extra_values = list(extra_values)
    _check_inputs(offsets, n_src, out_capacity, extra_values)
    dev = offsets.device
    idx = torch.arange(offsets.shape[0], dtype=torch.int32, device=dev)
    off_eff = torch.where(idx < n_src, offsets,
                          torch.full((), _I32_MAX, dtype=torch.int32,
                                     device=dev))
    slots = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(off_eff, slots, right=True) - 1
    seg = torch.clamp(seg, min=0)
    return (seg.to(torch.int32), off_eff[seg],
            [v[seg] for v in extra_values])


def expand_ids(offsets: torch.Tensor, n_src: torch.Tensor,
               out_capacity: int) -> torch.Tensor:
    """seg_ids only — see :func:`expand_fills`."""
    seg, _off, _ = expand_fills(offsets, n_src, out_capacity, ())
    return seg
