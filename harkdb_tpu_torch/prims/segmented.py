"""Segmented primitives: the log-doubling scan behind kernel B, and the
two iotas the distributed layer calls.

Counterparts of ``harkdb_tpu.prims.segmented`` ``doubling_segmented_scan``,
``replicated_iota`` and ``segmented_iota``; the rest of that module
(flag-array scans, reduces, expand) has no caller in the port and is not
ported. On a CUDA tensor ``segmented_iota``'s running max is kernel B over
one segment and ``replicated_iota``'s expansion is kernel D.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


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
    if n_valid is None:
        n_valid = torch.full((), n, dtype=torch.int32, device=dev)
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
