"""Kernel B: inclusive segmented scan (``csrc/segscan.cu``).

Counterpart of ``harkdb_tpu/kernels/segscan.py`` (``flat_segscan``, the
carry-chained Pallas kernel). Same contract: each column scans under one
shared segment id ``sid`` whose segments are contiguous and non-decreasing;
the carry starts as (sid -1, ``neutral``), so rows of a leading sid -1 run
get ``op(value, neutral)``. Integer results are exact (add and mul wrap mod
2^32); float ``add`` combines in another order than the plain version and
may differ in the last bits.

Two forms serve the running max / min (``prims/scan.py``): ``sid=None`` is
one segment (sid 0 on every row, none read), and ``reverse=True`` scans
from the last row to the first, so ``out[i]`` covers ``x[i:]`` (the
flip / scan / flip pattern); with a sid, the sid is then non-decreasing
from the last row to the first.

``flat_segscan`` launches the CUDA kernel for CUDA tensors and raises on
anything it does not take. ``flat_segscan_reference`` is the plain PyTorch
version: a log-doubling scan (:func:`doubling_segmented_scan`) over the
whole column, which serves CPU tensors and is the baseline the kernel is
compared and timed against on the card.

:func:`agg_segscan` and :func:`agg_neutral` adapt the kernel to the
aggregates' names and to every dtype: the kernel scans int32 and float32,
so narrower types scan widened and convert back, and bool add / mul scan
as max / min (or / and, as ``jnp.add`` / ``jnp.multiply`` define them).
The GROUP BY, the windows, the mesh's global windows and the public
segmented primitives scan through them.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, Sequence

import torch

from harkdb_tpu_torch.kernels import _lib

#: Number of kernel launches ``flat_segscan`` made in this process: one per
#: group of up to 8 columns.
LAUNCHES = 0
#: The launches of those with ``sid=None`` (one segment).
ONE_SEGMENT_LAUNCHES = 0

_COLS_PER_LAUNCH = 8

OPS = {
    "add": torch.add,
    "max": torch.maximum,
    "min": torch.minimum,
    "mul": torch.mul,
}
_OP_CODE = {"add": 0, "max": 1, "min": 2, "mul": 3}
#: The kernel's op for each aggregate :func:`agg_segscan` scans.
_AGG_OP = {"sum": "add", "prod": "mul", "max": "max", "min": "min"}
_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def segscan_supported(op_name: str, dtype: torch.dtype) -> bool:
    """Whether kernel B scans ``dtype`` columns under ``op_name``: add, max,
    min or mul over int32 or float32. The JAX package's predicate takes
    every 4-byte type, uint32 too; the ingest gives tables int32 and
    float32 columns, so no uint32 column reaches the kernel in either."""
    return op_name in OPS and dtype in _DTYPE_CODE


def _check_inputs(op_name: str, sid: Optional[torch.Tensor],
                  cols: Sequence[torch.Tensor]) -> None:
    if op_name not in OPS:
        raise ValueError(f"unknown scan op {op_name!r}")
    if not cols:
        raise ValueError("flat_segscan needs at least one column")
    n = cols[0].shape[0] if cols[0].dim() == 1 else -1
    if sid is not None and (sid.dim() != 1 or sid.dtype != torch.int32
                            or sid.shape[0] != n):
        raise ValueError("sid must be None or a 1-D int32 tensor as long as "
                         "the columns")
    dt = cols[0].dtype
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n:
            raise ValueError(f"column of shape {tuple(c.shape)}, expected "
                             f"({n},)")
        if c.dtype != dt or not segscan_supported(op_name, dt):
            raise ValueError(f"columns must all be int32 or all float32, "
                             f"got {[str(x.dtype) for x in cols]}")


def doubling_segmented_scan(op: Callable, sid: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan via log-step doubling (Hillis–Steele).

    ``sid`` assigns each row a segment id; rows of a segment must be
    contiguous (the caller has sorted by key). ``values`` is ``(n,)`` or
    ``(n, k)`` — columns scan independently under the shared ``sid``.
    Out-of-range predecessors read id -1 and value 0, exactly as the JAX
    version does, so results match it bit for bit (float sums combine in
    the same order).
    """
    n = values.shape[0]
    out = values
    d = 1
    while d < n:
        prev_sid = torch.cat([sid.new_full((d,), -1), sid[:-d]])
        prev = torch.cat([out.new_zeros((d,) + tuple(out.shape[1:])),
                          out[:-d]])
        same = sid == prev_sid
        if out.dim() > 1:
            same = same[:, None]
        out = torch.where(same, op(out, prev), out)
        d *= 2
    return out


def _neutral_bits(neutral, dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return struct.unpack("<i", struct.pack("<f", float(neutral)))[0]
    v = int(neutral)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"neutral {neutral!r} does not fit int32")
    return v


def flat_segscan(op_name: str, sid: Optional[torch.Tensor],
                 cols: Sequence[torch.Tensor], neutral,
                 reverse: bool = False) -> List[torch.Tensor]:
    """Inclusive segmented scan of each column under the shared ``sid``
    (one segment if ``sid`` is None), from the last row if ``reverse``.

    CPU tensors take :func:`flat_segscan_reference`; CUDA tensors launch
    the one-pass kernel (one launch per 8 columns, no host
    synchronisation) or raise.
    """
    cols = list(cols)
    _check_inputs(op_name, sid, cols)
    dev = cols[0].device
    if any(t.device != dev for t in cols + ([] if sid is None else [sid])):
        raise ValueError("sid and the columns must share a device")
    if dev.type == "cpu":
        return flat_segscan_reference(op_name, sid, cols, neutral, reverse)
    if dev.type != "cuda":
        raise ValueError(f"flat_segscan runs on CUDA or CPU, not {dev}")
    global LAUNCHES, ONE_SEGMENT_LAUNCHES
    lib = _lib.library()
    n = cols[0].shape[0]
    dtype = cols[0].dtype
    sid = None if sid is None else sid.contiguous()
    ins = [c.contiguous() for c in cols]
    outs = [torch.empty_like(c) for c in ins]
    if n == 0:
        return outs
    stream = _lib.stream_handle(dev)
    for g in range(0, len(ins), _COLS_PER_LAUNCH):
        group_in = ins[g:g + _COLS_PER_LAUNCH]
        group_out = outs[g:g + _COLS_PER_LAUNCH]
        scratch = torch.zeros(
            lib.harkdb_segscan_scratch_words(n, len(group_in)),
            dtype=torch.int64, device=dev)
        in_ptrs = _lib.pointer_array(group_in)
        out_ptrs = _lib.pointer_array(group_out)
        _lib.check(lib.harkdb_segscan(
            _OP_CODE[op_name], _DTYPE_CODE[dtype],
            None if sid is None else sid.data_ptr(), n, len(group_in),
            in_ptrs, out_ptrs, _neutral_bits(neutral, dtype), int(reverse),
            scratch.data_ptr(), stream,
        ), f"segscan kernel ({op_name}, {dtype})")
        LAUNCHES += 1
        if sid is None:
            ONE_SEGMENT_LAUNCHES += 1
    return outs


def flat_segscan_reference(op_name: str, sid: Optional[torch.Tensor],
                           cols: Sequence[torch.Tensor], neutral,
                           reverse: bool = False) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`flat_segscan`.

    ``sid=None`` is sid 0 on every row; ``reverse`` flips the inputs, scans
    and flips the results back. The doubling scan runs on ``sid + 1``: its
    out-of-range fill id is -1, which then never equals a row's id (ids
    are >= -1), so each row combines exactly the earlier rows of its own
    segment. The carry's start value is folded into the sid -1 rows
    afterwards, as the kernel does.
    """
    cols = list(cols)
    _check_inputs(op_name, sid, cols)
    if sid is None:
        sid = torch.zeros(cols[0].shape[0], dtype=torch.int32,
                          device=cols[0].device)
    if reverse:
        outs = flat_segscan_reference(
            op_name, torch.flip(sid, [0]), [torch.flip(c, [0]) for c in cols],
            neutral)
        return [torch.flip(o, [0]) for o in outs]
    op = OPS[op_name]
    shifted = sid + 1
    lead = sid == -1
    outs = []
    for c in cols:
        out = doubling_segmented_scan(op, shifted, c)
        ne = torch.full((), neutral, dtype=c.dtype, device=c.device)
        outs.append(torch.where(lead, op(out, ne), out))
    return outs


def agg_neutral(op_name: str, dtype: torch.dtype):
    """The neutral element of the aggregate ``op_name`` (sum, count, prod,
    max, min) over ``dtype``, as a Python scalar."""
    if op_name in ("sum", "count"):
        return 0
    if op_name == "prod":
        return 1
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        return float(info.min) if op_name == "max" else float(info.max)
    if dtype == torch.bool:
        return op_name == "min"
    info = torch.iinfo(dtype)
    if op_name == "max":
        return int(info.min)
    if op_name == "min":
        return int(info.max)
    raise ValueError(f"Unknown aggregate {op_name!r}")


def agg_segscan(op: str, sid: Optional[torch.Tensor],
                cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """Segmented scan of same-dtype columns under the aggregate ``op``
    (sum, prod, max, min) through :func:`flat_segscan`. The kernel takes
    int32/float32; other dtypes scan in those and convert back (bool
    add/mul are or/and, as jnp.add/jnp.multiply define them on bools)."""
    dt = cols[0].dtype
    if segscan_supported(_AGG_OP[op], dt):
        return flat_segscan(_AGG_OP[op], sid, cols, agg_neutral(op, dt))
    if dt == torch.bool:
        op = {"sum": "max", "prod": "min"}.get(op, op)
    work = torch.float32 if dt.is_floating_point else torch.int32
    out = flat_segscan(_AGG_OP[op], sid, [c.to(work) for c in cols],
                       agg_neutral(op, work))
    return [o.to(dt) for o in out]
