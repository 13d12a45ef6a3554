"""Flag-array segmented operations: the flat-data-parallel substrate.

Counterpart of ``harkdb_tpu.prims.segmented``, with its signatures and
contracts (those of the reference's vendored diku-dk/segmented library,
``segmented.fut``): flags in (``True`` opens a segment, element 0 always
opens one), padded outputs, ``n_valid`` counts, ``(out, count)`` returns.

  * ``segmented_scan``      — inclusive per-segment scan
  * ``segmented_reduce``    — one value per segment, ``ne`` past the last
  * ``replicated_iota``     — [2,3,1] → [0,0,1,1,1,2]
  * ``segmented_iota``      — per-segment restarting iota
  * ``expand``              — irregular nested flattening
  * ``expand_reduce``       — ``expand``, then one fold per source row
  * ``expand_outer_reduce`` — the same with ``ne`` folded in first

The operators ``torch.add``, ``torch.maximum``, ``torch.minimum`` and
``torch.mul`` (``jnp.add`` and its siblings) scan through kernel B
(``kernels.segscan.flat_segscan``) under segment ids from a cumsum of the
flags; a reduce then packs the segment ends with kernel A; the expansion is
kernel D (``replicated_iota``) and the in-segment positions kernel B over
one segment (``segmented_iota``). Types narrower than 4 bytes scan widened
to int32 / float32 (``kernels.segscan.agg_segscan``); on a CUDA tensor an
8-byte type raises (the kernel scans 32-bit words; the JAX package without
x64 never makes one). Any other callable takes a plain log-doubling scan over
(flag, value) pairs on either device, as the JAX package takes
``lax.associative_scan`` (``_generic_segmented_scan``), which is no Pallas
kernel either. Integer results equal the JAX package's bit for bit; a
float add differs in rounding (JAX subtracts prefix sums, kernel B sums
each segment).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from harkdb_tpu_torch.kernels.segscan import (
    agg_segscan, doubling_segmented_scan,
)
from harkdb_tpu_torch.prims.compaction import _count, compact_arrays


#: Operators kernel B scans, by the GROUP BY's name for them.
_KERNEL_OPS = {torch.add: "sum", torch.maximum: "max", torch.minimum: "min",
               torch.mul: "prod", torch.multiply: "prod"}


def _pair_scan(op: Callable, flags: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of (flag, value) pairs under ``combine(a, b) = (a.f |
    b.f, b.v if b.f else op(a.v, b.v))``, by log-step doubling: the plain
    form for any associative ``op``."""
    f, v = flags.to(torch.bool), values
    n, d = v.shape[0], 1
    while d < n:
        v = torch.cat([v[:d], torch.where(f[d:], v[d:], op(v[:-d], v[d:]))])
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d *= 2
    return v


def _scan(op: Callable, flags: torch.Tensor,
          values: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of the 1-D ``values`` within the segments ``flags``
    opens (element 0 always opens one): kernel B for ``_KERNEL_OPS``."""
    name = _KERNEL_OPS.get(op)
    if name is None:
        return _pair_scan(op, flags, values)
    f = flags.to(torch.int32)
    sid = torch.cumsum(f, 0, dtype=torch.int32) - f[:1]
    if values.element_size() > 4:
        if values.device.type == "cuda":
            raise ValueError(
                f"segmented {name} of {values.dtype} on the card: kernel B "
                f"scans types of at most 4 bytes")
        return doubling_segmented_scan(op, sid, values)
    return agg_segscan(name, sid, [values])[0]


def _fill(ne, like: torch.Tensor) -> torch.Tensor:
    """``ne`` as a 0-d tensor of ``like``'s dtype, filled on its device."""
    return torch.full((), ne, dtype=like.dtype, device=like.device)


def segmented_scan(op: Callable, ne, flags: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented scan of the 1-D ``values``: ``flags[i]`` True
    starts a new segment at i (``harkdb_tpu/prims/segmented.py:85``).

    Oblivious to validity, as in JAX: the caller pre-masks padding to
    ``ne`` if needed; ``ne`` itself is not read.
    """
    return _scan(op, flags, values)


def segmented_reduce(op: Callable, ne, flags: torch.Tensor,
                     values: torch.Tensor, n_valid=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment reduction (``harkdb_tpu/prims/segmented.py:132``).

    Returns ``(out, n_segments)``: ``out`` keeps the input capacity, with
    ``out[s]`` the reduction of segment ``s`` for ``s < n_segments`` and
    ``ne`` beyond. Element 0 always opens segment 0, flagged or not; rows
    at index >= ``n_valid`` are ignored. The scan's value at each
    segment's last row is packed to the front by kernel A.
    """
    n = values.shape[0]
    dev = values.device
    nv = _count(n_valid, n, dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = idx < nv
    f = (flags.to(torch.bool) | (idx == 0)) & valid
    scanned = _scan(op, f, values)
    next_f = torch.cat([f[1:], f.new_zeros(1)])
    is_end = valid & (next_f | (idx == nv - 1))
    (packed,), n_segments = compact_arrays([scanned], is_end, nv)
    out = torch.where(idx < n_segments, packed, _fill(ne, packed))
    return out, n_segments


def replicated_iota(reps: torch.Tensor, out_capacity: int,
                    n_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[2,3,1] → [0,0,1,1,1,2] (``harkdb_tpu/prims/segmented.py:178``).

    ``reps`` is padded; ``n_valid`` counts live entries. Returns ``(ids,
    total)``; ids beyond ``total`` are ``len(reps)``. A zero-length segment
    never appears: its offset equals the next segment's, and the expansion
    takes the last of equal offsets, as the JAX version's max-scatter does.
    The expansion is ``kernels.expand.expand_ids`` over the exclusive
    cumsum of ``reps`` (kernel D on a card).
    """
    from harkdb_tpu_torch.kernels.expand import expand_ids

    n = reps.shape[0]
    dev = reps.device
    n_valid = _count(n_valid, n, dev)
    valid = torch.arange(n, dtype=torch.int32, device=dev) < n_valid
    reps = torch.where(valid, reps.to(torch.int32), 0)
    offsets = torch.cumsum(reps, 0, dtype=torch.int32) - reps
    total = reps.sum(dtype=torch.int32)
    ids = expand_ids(offsets, n_valid, out_capacity)
    out_valid = torch.arange(out_capacity, dtype=torch.int32, device=dev) < total
    return torch.where(out_valid, ids, n), total


def segmented_iota(flags: torch.Tensor) -> torch.Tensor:
    """Per-segment restarting iota: [F,F,T,F] → [0,1,0,1]
    (``harkdb_tpu/prims/segmented.py:219``): ``idx`` minus the running max
    of the flagged positions (``prims.scan.running_max``: kernel B over one
    segment on a card; ``torch.cummax`` on a CUDA tensor scans in one
    thread block). Rows before the first flag restart at 0."""
    from harkdb_tpu_torch.prims.scan import running_max

    idx = torch.arange(flags.shape[0], dtype=torch.int32, device=flags.device)
    return idx - running_max(torch.where(flags.to(torch.bool), idx, 0))


def _expansion(sizes: torch.Tensor, out_capacity: int, nv: torch.Tensor):
    """``replicated_iota`` of ``sizes`` (``nv`` live) and, per output slot,
    whether it opens a run, its position in the run and its source row
    (clamped)."""
    seg_ids, total = replicated_iota(sizes, out_capacity, nv)
    starts = torch.ones_like(seg_ids, dtype=torch.bool)
    starts[1:] = seg_ids[1:] != seg_ids[:-1]
    live = torch.arange(out_capacity, dtype=torch.int32,
                        device=sizes.device) < total
    local = torch.where(live, segmented_iota(starts), 0)
    safe_ids = torch.clamp(seg_ids, max=sizes.shape[0] - 1)
    return total, starts, local, safe_ids


def expand(sizes: torch.Tensor,
           get: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           out_capacity: int, n_valid=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Irregular flattening (``harkdb_tpu/prims/segmented.py:234``).

    ``sizes[i]`` elements are produced for source row i; ``get(src_ids,
    locals)`` is applied over the flat output (source index and position
    within its segment). Returns ``(out, total)`` padded to
    ``out_capacity``; padding slots call ``get`` with the last source index
    and position 0.
    """
    total, _starts, local, safe_ids = _expansion(
        sizes, out_capacity, _count(n_valid, sizes.shape[0], sizes.device))
    return get(safe_ids, local), total


def _op_identity(name: Optional[str], dtype: torch.dtype, ne):
    """What a source row whose elements all fall past the output capacity
    reduces to: JAX's ``segment_*`` identity for the kernel operators,
    ``ne`` for any other."""
    if name is None or name in ("sum", "prod"):
        return {"sum": 0, "prod": 1}.get(name, ne)
    if dtype == torch.bool:
        return name == "min"
    if dtype.is_floating_point:
        return float("-inf") if name == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if name == "max" else info.max


def expand_reduce(sizes: torch.Tensor,
                  get: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  op: Callable, ne, out_capacity: int, n_valid=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expand``, then fold each source row's elements back to one value
    (``harkdb_tpu/prims/segmented.py:260``): ``out[i]`` is the ``op``-fold
    of ``get(i, 0..sizes[i]-1)``. Rows with ``sizes[i] == 0`` yield ``ne``.
    Returns ``(out, n_valid)`` with ``out`` padded to the sizes capacity.
    The fold is a segmented scan of the expanded values, read at each
    row's last slot (the last slot that fits when the output is cut)."""
    n = sizes.shape[0]
    dev = sizes.device
    nv = _count(n_valid, n, dev)
    total, starts, local, safe_ids = _expansion(sizes, out_capacity, nv)
    scanned = _scan(op, starts, get(safe_ids, local))
    valid_row = torch.arange(n, dtype=torch.int32, device=dev) < nv
    reps = torch.where(valid_row, sizes.to(torch.int32), 0)
    end = torch.cumsum(reps, 0, dtype=torch.int32) - 1
    gone = _op_identity(_KERNEL_OPS.get(op), scanned.dtype, ne)
    padded = torch.cat([scanned, scanned.new_full((1,), gone)])
    pos = torch.where(end - reps + 1 < out_capacity,
                      torch.clamp(end, max=out_capacity - 1), out_capacity)
    out = torch.where(valid_row & (sizes > 0), padded[pos],
                      _fill(ne, scanned))
    return out, nv


def expand_outer_reduce(sizes: torch.Tensor,
                        get: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                        op: Callable, ne, out_capacity: int, n_valid=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`expand_reduce`, with ``ne`` folded in as the first
    element (``harkdb_tpu/prims/segmented.py:307``): a non-empty row yields
    ``op(ne, fold)``, an empty row ``ne`` unfolded."""
    red, nv = expand_reduce(sizes, get, op, ne, out_capacity, n_valid)
    valid_row = torch.arange(sizes.shape[0], dtype=torch.int32,
                             device=sizes.device) < nv
    ne_t = _fill(ne, red)
    out = torch.where(valid_row & (sizes > 0),
                      op(torch.full_like(red, ne_t), red), ne_t)
    return out, nv
