"""Skew-aware salted repartitioning for distributed joins.

Counterpart of ``harkdb_tpu.parallel.skew``, with the same scheme:

  1. **Detect** (local): each rank counts its probe-side keys and nominates
     up to ``HOT_K`` keys whose local count exceeds ``skew_threshold x
     (local live rows / D)``; an all_gather replicates the union H (D x
     HOT_K candidates with validity flags).
  2. **Salt the probe side**: rows with hot keys go round-robin,
     ``(row position + rank) % D``, instead of by hash.
  3. **Replicate the build side**: rows with hot keys are expanded D-fold
     (copy j → rank j), the others go by hash.

Both sides test membership against the same replicated H, a probe row
lives on exactly one rank, and build copies only meet probe rows of their
key, so no pair is lost or doubled. On a card the expansion is kernel D
(``prims.segmented.replicated_iota``) and the copy index kernel B
(``segmented_iota``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from harkdb_tpu_torch.ops.sort import lexsort_permutation
from harkdb_tpu_torch.parallel.shuffle import hash_to_bucket
from harkdb_tpu_torch.prims.segmented import replicated_iota, segmented_iota

Tensor = torch.Tensor

HOT_K = 16          # max hot keys nominated per rank


def detect_hot_keys(key: Tensor, n_valid: Tensor, n_shards: int,
                    threshold_frac: float, mesh) -> Tuple[Tensor, Tensor]:
    """Local heavy-hitter detection + all_gather
    (``harkdb_tpu/parallel/skew.py:44``).

    Returns ``(H, HV)``, the same on every rank: hot key candidates of
    shape (D * HOT_K,) and their validity. A key is nominated when its
    local count exceeds ``threshold_frac * live_rows / n_shards`` (at least
    2), in float32 as in JAX; candidates are the HOT_K most frequent keys,
    ties by ascending key.
    """
    n = key.shape[0]
    dev = key.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = idx < n_valid
    hi = torch.iinfo(key.dtype).max
    skey = torch.sort(torch.where(valid, key, hi)).values
    prev = torch.cat([skey[:1], skey[:-1]])
    is_start = valid & ((idx == 0) | (skey != prev))
    seg = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    target = torch.where(valid, seg, n).to(torch.int64)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, target, torch.ones(n, dtype=torch.int32, device=dev))[:n]
    seg_keys = torch.full((n + 1,), hi, dtype=key.dtype, device=dev)
    seg_keys = seg_keys.scatter_reduce(0, target, skey, "amin")[:n]
    nv = n_valid.to(torch.float32)
    thresh = torch.clamp((threshold_frac * nv / n_shards).to(torch.int32),
                         min=2)
    # Top-HOT_K by count: a stable sort on -count keeps segments (ascending
    # keys) in order within a count.
    order = lexsort_permutation([-counts])[:HOT_K]
    hot = _fill(seg_keys[order], HOT_K, hi)
    hot_valid = _fill(counts[order], HOT_K, 0) > thresh
    return (mesh.all_gather(hot).reshape(-1),
            mesh.all_gather(hot_valid.to(torch.int32)).reshape(-1) > 0)


def _fill(a: Tensor, k: int, value) -> Tensor:
    """``a`` padded with ``value`` to ``k`` entries."""
    if a.shape[0] >= k:
        return a
    return torch.cat([a, a.new_full((k - a.shape[0],), value)])


def is_member(key: Tensor, H: Tensor, HV: Tensor) -> Tensor:
    """key[i] ∈ {H[j] : HV[j]} (H and HV are read back: D x HOT_K
    entries)."""
    return torch.isin(key, H[HV])


def salted_probe_dest(key: Tensor, hot: Tensor, n_shards: int,
                      shard_id: int) -> Tensor:
    """Probe routing: hot keys round-robin over all ranks, rest by hash."""
    n = key.shape[0]
    spread = (torch.arange(n, dtype=torch.int32, device=key.device)
              + shard_id) % n_shards
    return torch.where(hot, spread, hash_to_bucket(key, n_shards))


def replicate_hot_build(cols: Dict[str, Tensor], key_name: str,
                        n_valid: Tensor, hot: Tensor, n_shards: int,
                        out_capacity: int
                        ) -> Tuple[Dict[str, Tensor], Tensor, Tensor]:
    """Expand build-side rows: hot rows D-fold (copy j routed to rank j),
    others once (routed by hash).

    Returns ``(exp_cols, exp_n, dest)`` with arrays of ``out_capacity``
    rows, which must hold the expansion: the caller sizes it from its live
    and hot rows (JAX sizes it statically and flags an overflow).
    """
    n = next(iter(cols.values())).shape[0]
    dev = hot.device
    valid = torch.arange(n, dtype=torch.int32, device=dev) < n_valid
    sizes = torch.where(valid, torch.where(hot, n_shards, 1), 0)
    total = sizes.sum(dtype=torch.int32)

    seg_ids, _ = replicated_iota(sizes.to(torch.int32), out_capacity, n_valid)
    live = torch.arange(out_capacity, dtype=torch.int32, device=dev) < total
    src = torch.where(live, torch.clamp(seg_ids, max=n - 1), 0).long()
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        seg_ids[1:] != seg_ids[:-1]])
    copy_idx = segmented_iota(starts)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    exp_cols = {name: torch.where(live, col[src], zero.to(col.dtype))
                for name, col in cols.items()}
    hot_exp = live & hot[src]
    dest = torch.where(hot_exp, copy_idx % n_shards,
                       hash_to_bucket(exp_cols[key_name], n_shards))
    dest = torch.where(live, dest, n_shards)
    return exp_cols, total, dest
