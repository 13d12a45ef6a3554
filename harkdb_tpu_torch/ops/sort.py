"""Sort operators (ORDER BY and the substrate for sort-based ops).

Counterpart of ``harkdb_tpu.ops.sort``. JAX sorts several operands at once
(``lax.sort(num_keys=…, is_stable=True)``); torch sorts one key. The
multi-key stable sort is built here as :func:`lexsort_permutation`: every
key maps to a non-negative integer of known width whose order is the key's
order under ``lax.sort``, adjacent keys pack into words of at most 63 bits
(:func:`order_words`), and one stable radix sort per word
(``kernels.radix_sort.sort_pairs``) runs from the least significant word
to the most significant, over that word's own bits, carrying an int32
permutation. A word of at most 32 bits sorts as a 4-byte word: a lone
int32 key is its own bits with the sign bit flipped. Payload columns then
move with one gather each; a caller with one int32 payload (the join's
tagged row index) hands it to the sort to carry instead. Two int32 keys,
a drop flag and a key, or a drop flag and an ORDER BY key, fit one word:
one sort.

Engine conventions honored:
  * padded batches — padding rows always sort to the back, regardless of the
    junk values they carry;
  * stability — equal keys preserve input row order;
  * float keys order as ``lax.sort`` orders them: -0.0 equals 0.0, and NaN
    (of either sign) sorts after +inf;
  * multi-key lexicographic sort with per-key ASC/DESC.

Every key-order view of the port lives here: the sort's
(:func:`order_words`), the top-k selection's and the mesh's range
partition's (:func:`ieee_order_view`, which ranks a float by its bits and
so a NaN with its sign bit set below -inf), the reference's u32 group-key
order (:func:`u32_order_key`) and DESC's (:func:`descending_transform`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.kernels.radix_sort import sort_pairs

_WORD_BITS = 63          # a word of several keys stays a non-negative int64

_KEY_BITS = {torch.bool: 1, torch.int8: 8, torch.uint8: 8, torch.int16: 16,
             torch.int32: 32, torch.float32: 32, torch.int64: 64,
             torch.float64: 64}


def descending_transform(key: torch.Tensor) -> torch.Tensor:
    """Order-reversing bijection so a DESC key can ride an ascending sort.

    Signed ints: bitwise-not (``~x = -x-1``) is strictly decreasing and total
    (handles INT_MIN, unlike negation). Floats: negation.
    """
    if key.dtype.is_floating_point:
        return -key
    if key.dtype == torch.bool:
        return ~key
    return torch.bitwise_not(key)


def u32_order_key(key: torch.Tensor) -> torch.Tensor:
    """Order-preserving signed view of an int key's u32 bit pattern.

    Flipping the sign bit maps unsigned comparison order onto signed order
    (an involution: apply again to undo). Used by the
    ``compat_u32_key_order`` mode to reproduce the reference's radix-sort
    key order (``groupby.fut:21-22``: negatives sort AFTER positives).
    """
    if key.dtype.is_floating_point or key.dtype == torch.bool:
        return key
    return key ^ torch.iinfo(key.dtype).min


def ieee_order_view(key: torch.Tensor, descending: bool) -> torch.Tensor:
    """Monotone integer view of a key by its IEEE-754 bits, for the top-k
    selection and the mesh's range partition (the JAX package's
    ``_route_order_view``): floats as float32 by the total-order bit trick,
    so a NaN with its sign bit set ranks below -inf and any other NaN above
    +inf; keys of up to 4 bytes as int32, int64 as it is; DESC keys
    bitwise-NOT'd. The sort's view (:func:`order_words`) differs on
    purpose: it puts every NaN last."""
    if key.dtype.is_floating_point:
        bits = key.to(torch.float32).view(torch.int32)
        key = torch.where(bits < 0, torch.full_like(bits, -(1 << 31)) - bits,
                          bits)
    elif key.dtype != torch.int64:
        key = key.to(torch.int32)
    return torch.bitwise_not(key) if descending else key


def _pad_to_max(key: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Replace padding rows' key values with the dtype max so they sort last
    while keeping the key array monotone after the sort."""
    n = key.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    if key.dtype.is_floating_point:
        hi = torch.finfo(key.dtype).max
    elif key.dtype == torch.bool:
        hi = True
    else:
        hi = torch.iinfo(key.dtype).max
    return torch.where(idx < n_valid, key,
                       torch.full((), hi, dtype=key.dtype, device=key.device))


def _key_bits(dtype: torch.dtype) -> int:
    if dtype not in _KEY_BITS:
        raise TypeError(f"unsupported sort key dtype {dtype}")
    return _KEY_BITS[dtype]


def _order_bits(key: torch.Tensor, dtype: torch.dtype = torch.int64
                ) -> Tuple[torch.Tensor, int]:
    """``(u, bits)``: ``u`` of ``dtype`` (int64, or int32 for a key of at
    most 32 bits) whose bits, read as an unsigned number in [0, 2**bits),
    order like ``key`` under ``lax.sort``. Always a new tensor."""
    dt = key.dtype
    bits = _key_bits(dt)
    if dt == torch.bool:
        return key.to(dtype), 1
    if dt.is_floating_point:
        # lax.sort's float order: -0.0 == 0.0, every NaN one value after +inf.
        key = torch.where(key == 0, torch.zeros_like(key), key)
        key = torch.where(torch.isnan(key),
                          torch.full_like(key, float("nan")), key)
        b = key.view(torch.int32 if dt == torch.float32 else torch.int64)
        # negative floats reverse every bit, the others flip the sign bit
        u = torch.where(b < 0, ~b, b ^ torch.iinfo(b.dtype).min)
        if u.dtype != dtype:
            u = u.to(dtype) & 0xFFFFFFFF
        return u, bits
    if dt == dtype:                     # int32 or int64 in its own width
        return key ^ torch.iinfo(dt).min, bits       # the sign bit flipped
    return key.to(dtype) - torch.iinfo(dt).min, bits


def _word_groups(keys: Sequence[torch.Tensor]) -> List[list]:
    """The keys of each order word and its bits, least significant word
    first, each word's keys least significant first; from dtypes alone."""
    groups: List[list] = []             # [keys, bits] per word
    for key in reversed(list(keys)):
        b = _key_bits(key.dtype)
        if not groups or groups[-1][1] + b > _WORD_BITS:
            groups.append([[], 0])
        groups[-1][0].append(key)
        groups[-1][1] += b
    return groups


def order_words(keys: Sequence[torch.Tensor]
                ) -> List[Tuple[torch.Tensor, int]]:
    """``(word, bits)`` per order word, least significant first: the word's
    bits, read as an unsigned number in [0, 2**bits), order like its keys'
    tuple under ``lax.sort``, and equal words are equal tuples but for
    floats (-0.0 and 0.0, the NaNs). int32 for at most 32 bits, else int64:
    one key of 8 bytes, or adjacent keys packed in at most 63 bits."""
    words = []
    for members, bits in _word_groups(keys):
        if len(members) == 1:
            words.append(_order_bits(
                members[0], torch.int32 if bits <= 32 else torch.int64))
            continue
        acc, at = None, 0
        for key in members:
            u, b = _order_bits(key)
            acc = u if acc is None else acc | (u << at)
            at += b
        # int64 to int32 keeps the low 32 bits (two's complement)
        words.append((acc.to(torch.int32) if bits <= 32 else acc, bits))
    return words


def one_integer_word(keys: Sequence) -> bool:
    """Whether the keys (tensors, or their dtypes) are integers (bool
    included) that share one order word: then the sorted word's runs are
    the key tuple's runs."""
    dtypes = [k if isinstance(k, torch.dtype) else k.dtype for k in keys]
    bits = [_key_bits(d) for d in dtypes]
    return ((len(bits) == 1 or sum(bits) <= _WORD_BITS)
            and not any(d.is_floating_point for d in dtypes))


def lexsort_permutation(keys: Sequence[torch.Tensor],
                        values: Optional[torch.Tensor] = None):
    """Stable lexicographic sort (``keys[0]`` most significant), ties in
    input order.

    Without ``values``: the int32 permutation, ``perm[i]`` = source row of
    output row i. With ``values`` (int32, one a row): ``(sorted_word,
    sorted_values)``, the most significant order word (:func:`order_words`)
    in sorted order and ``values`` permuted; where the keys make one word,
    ``values`` rides the sort itself and is handed over as
    :func:`sort_pairs` says.
    """
    words = order_words(keys)
    n = keys[0].shape[0]
    rides = values is not None and len(words) == 1
    carry = (values if rides else
             torch.arange(n, dtype=torch.int32, device=keys[0].device))
    sword = None
    for i, (w, bits) in enumerate(words):
        if i:
            w = w.index_select(0, carry)
        sword, carry = sort_pairs(w, bits, carry)
    if values is None:
        return carry
    return sword, carry if rides else values.index_select(0, carry)


def sort_permutation(
    keys: Sequence[torch.Tensor],
    n_valid: torch.Tensor,
    descending: Optional[Sequence[bool]] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable lexicographic sort of the live rows.

    Returns ``(perm, sorted_keys)``: ``perm[i]`` = source row of output row i
    (int32). Live rows occupy output positions ``[0, n_valid)``; padding rows
    follow in their original relative order. ``sorted_keys`` are the
    transformed keys after permutation (pads replaced with dtype max; DESC
    keys transformed).
    """
    keys = list(keys)
    if descending is None:
        descending = [False] * len(keys)
    eff = []
    for k, desc in zip(keys, descending):
        if desc:
            k = descending_transform(k)
        eff.append(_pad_to_max(k, n_valid))
    perm = lexsort_permutation(eff)
    return perm, [k[perm] for k in eff]


def sort_batch(
    batch: ColumnBatch,
    key_names: Sequence[str],
    descending: Optional[Sequence[bool]] = None,
    key_arrays: Optional[Sequence[torch.Tensor]] = None,
    mask: Optional[torch.Tensor] = None,
) -> ColumnBatch:
    """ORDER BY: reorder all columns by the sort keys.

    ``key_arrays`` optionally supplies precomputed key columns (ORDER BY
    expressions) in place of ``key_names`` lookups. ``mask`` fuses a row
    filter (WHERE / HAVING predicate) into the same sort: dropped rows ride
    to the back as the leading key and the output count shrinks.
    """
    keys = (
        list(key_arrays) if key_arrays is not None
        else [batch.column(k) for k in key_names]
    )
    if descending is None:
        descending = [False] * len(keys)
    n = batch.capacity
    idx = torch.arange(n, dtype=torch.int32, device=batch.device)
    valid = idx < batch.n_valid
    if mask is not None:
        valid = valid & mask
    n_out = valid.sum(dtype=torch.int32)
    eff = [~valid]
    for k, desc in zip(keys, descending):
        eff.append(descending_transform(k) if desc else k)
    perm = lexsort_permutation(eff)
    cols = {name: c[perm] for name, c in batch.columns.items()}
    return ColumnBatch(cols, n_out)
