"""Distributed hash shuffle — the engine's repartition-by-key primitive.

Counterpart of ``harkdb_tpu.parallel.shuffle``. JAX exchanges fixed
``(D, C)`` bucket buffers with one ``all_to_all`` per column and retries
with a doubled ``C`` when a bucket overflows, because XLA cannot send
variable sizes (``harkdb_tpu/parallel/shuffle.py:10-19``). torch.distributed
can, so an exchange here is:

  1. a stable partition of the live rows by destination rank
     (:func:`bucketize`: one launch of kernel A per bucket, mask ``dest ==
     j``, over every column's int32 words, which keeps local row order
     within a bucket; 0.178-0.181 ms at a rank's 2^22 rows x 3 words into
     4 buckets on an H100 against 0.202-0.589 ms for one stable
     ``torch.sort`` of the destinations and a gather, chip_smoke phase 10);
  2. one ``all_to_all`` of the D bucket counts and one host read of what
     every rank sends and receives;
  3. one ``all_to_all`` with those split sizes of every column at once,
     the buckets' words side by side in one int32 matrix
     (``sharded.word_columns``).

Rows arrive sender 0's first, then sender 1's, each sender's in its local
order: the order of JAX's ``compact_received``, with no gaps to pack. No
bucket can overflow, so there is no retry loop and no ``ShuffleOverflow``.
The received block's capacity is ``sharded.block_capacity`` of its rows.

``hash_to_bucket`` gives the bucket JAX gives for every key, so partial
aggregates and join rows land on the same ranks as JAX's shards, and float
partial sums group the same way.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from harkdb_tpu_torch.kernels.compact import flat_compact
from harkdb_tpu_torch.parallel.sharded import (
    block_capacity, unpack_words, word_columns,
)

Tensor = torch.Tensor

# Knuth multiplicative hash constant (2^32 / phi), split into 16-bit halves
# so that products stay below 2^48 in int64 (the full product of a uint32
# key reaches 2^63.3, past int64's sign bit).
_HASH_MULT = 2654435761
_MULT_HI, _MULT_LO = _HASH_MULT >> 16, _HASH_MULT & 0xFFFF
_MASK32 = 0xFFFFFFFF


def _as_uint32(key: Tensor) -> Tensor:
    """``key.astype(jnp.uint32)`` as an int64 tensor in [0, 2^32): integers
    wrap mod 2^32; floats truncate toward zero and saturate (NaN and
    negatives give 0), as XLA's float → uint32 conversion does."""
    if key.dtype.is_floating_point:
        k = torch.nan_to_num(key.to(torch.float64), nan=0.0)
        return torch.clamp(torch.trunc(k), 0, _MASK32).to(torch.int64)
    return key.to(torch.int64) & _MASK32


def hash_to_bucket(key: Tensor, n_buckets: int, salt: int = 0) -> Tensor:
    """Multiplicative hash → bucket id in [0, n_buckets), int32: the JAX
    package's uint32 arithmetic in int64, masked to 32 bits."""
    k = _as_uint32(key)
    if salt:
        k = k ^ ((salt * 0x9E3779B9) & _MASK32)
    h = (k * _MULT_LO + (((k * _MULT_HI) & 0xFFFF) << 16)) & _MASK32
    h = h ^ (h >> 16)
    return (h % n_buckets).to(torch.int32)


def bucketize(words: List[Tensor], dest: Tensor, n_valid: Tensor,
              n_buckets: int) -> Tuple[List[List[Tensor]], Tensor]:
    """Stable partition of the live rows' int32 ``words`` by ``dest``: one
    compaction (kernel A on a card) per bucket.

    Returns ``(buckets, counts)``: bucket j's words, its rows packed to the
    front in local row order, and the live rows per bucket (int32, on the
    rows' device)."""
    cols = {str(i): w for i, w in enumerate(words)}
    buckets, counts = [], []
    for j in range(n_buckets):
        out, n = flat_compact(cols, dest == j, n_valid)
        buckets.append([out[str(i)] for i in range(len(words))])
        counts.append(n)
    return buckets, torch.stack(counts)


def exchange(cols: Dict[str, Tensor], dest: Tensor, n_valid: Tensor,
             mesh) -> Tuple[Dict[str, Tensor], Tensor]:
    """Send the live rows of ``cols`` with ``dest == j`` to rank j.
    Returns the received columns, packed from row 0 (sender 0's rows
    first) at capacity ``block_capacity(rows)``, and their count (0-d
    int32)."""
    words, layout = word_columns(cols)
    buckets, counts = bucketize(words, dest, n_valid, mesh.size)
    recv = mesh.all_to_all(counts, [1] * mesh.size, [1] * mesh.size)
    both = torch.cat([counts, recv]).tolist()
    send_n, recv_n = both[:mesh.size], both[mesh.size:]
    n_out = sum(recv_n)
    send = torch.cat([torch.stack([w[:n] for w in b], 1)
                      for b, n in zip(buckets, send_n)])
    out = torch.zeros((block_capacity(n_out), len(words)),
                      dtype=torch.int32, device=send.device)
    mesh.all_to_all(send, send_n, recv_n, out=out[:n_out])
    count = torch.tensor(n_out, dtype=torch.int32, device=send.device)
    return unpack_words(out, layout), count


def repartition_by_key(cols: Dict[str, Tensor], key_name: str,
                       n_valid: Tensor, mesh, salt: int = 0
                       ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Full shuffle: rows land on rank ``hash(key) % D``. Returns (the
    received columns, their count)."""
    dest = hash_to_bucket(cols[key_name], mesh.size, salt)
    return repartition_with_dest(cols, dest, n_valid, mesh)


def repartition_with_dest(cols: Dict[str, Tensor], dest: Tensor,
                          n_valid: Tensor, mesh
                          ) -> Tuple[Dict[str, Tensor], Tensor]:
    """Shuffle on a precomputed per-row destination rank (skew-salted and
    range-partitioned routing use this)."""
    return exchange(cols, dest, n_valid, mesh)

