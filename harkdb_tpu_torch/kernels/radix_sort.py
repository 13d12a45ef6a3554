"""The stable radix pair sort (``csrc/radix_sort.cu``).

The sort under ``ops/sort.lexsort_permutation``, and so under every sort
of the single-device operators. The JAX package has no kernel of its own
here: it sorts with ``lax.sort``.

``sort_pairs`` sorts a word on its own low bits with an int32 value moving
along: for a CUDA tensor it calls CUB's onesweep radix pair sort in the
port's library, for a CPU tensor it takes ``sort_pairs_reference``, one
stable ``torch.sort``, which is also the baseline the library is compared
against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from harkdb_tpu_torch.kernels import _lib
from harkdb_tpu_torch.utils.metrics import count_sort

#: Number of pair sorts :func:`sort_pairs` ran in the card's library in this
#: process: one per call on a CUDA tensor with rows.
LAUNCHES = 0


def _check_pairs(word: torch.Tensor, bits: int, values: torch.Tensor) -> None:
    if word.dim() != 1 or word.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"word must be a 1-D int32 or int64 tensor, got "
                         f"{word.dtype} of shape {tuple(word.shape)}")
    if not 1 <= bits <= 8 * word.element_size():
        raise ValueError(f"bits {bits} outside [1, {8 * word.element_size()}]"
                         f" for a {word.dtype} word")
    if values.dtype != torch.int32 or values.shape != word.shape:
        raise ValueError(f"values must be int32 of shape {tuple(word.shape)}"
                         f", got {values.dtype} of {tuple(values.shape)}")
    if values.device != word.device:
        raise ValueError("word and values must share a device")


def sort_pairs(word: torch.Tensor, bits: int, values: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of ``word`` on its low ``bits`` bits, read as
    an unsigned number, with the int32 ``values`` moving along: returns
    ``(sorted_word, sorted_values)``.

    ``word`` is int32 (``bits`` <= 32) or int64 (<= 64). A CUDA tensor is
    sorted by the card's library (``csrc/radix_sort.cu``: CUB's onesweep
    over ``bits`` bits, no synchronisation); the word and values become one
    half of its double buffer, so the caller hands them over and their
    contents afterwards are unspecified. A CPU tensor takes
    :func:`sort_pairs_reference`; any other device raises. Counts the rows
    and bits sorted (``utils.metrics.count_sort``).
    """
    _check_pairs(word, bits, values)
    dev = word.device
    n = word.shape[0]
    count_sort(n, bits)
    if dev.type == "cpu":
        return sort_pairs_reference(word, bits, values)
    if dev.type != "cuda":
        raise ValueError(f"sort_pairs runs on CUDA or CPU, not {dev}")
    if n == 0:
        return word, values
    global LAUNCHES
    lib = _lib.library()
    key_bytes = word.element_size()
    temp_bytes = lib.harkdb_radix_sort_temp_bytes(n, key_bytes, bits)
    if temp_bytes < 0:
        _lib.check(-temp_bytes, "radix sort temp size")
    word, values = word.contiguous(), values.contiguous()
    word_alt, values_alt = torch.empty_like(word), torch.empty_like(values)
    temp = torch.empty(temp_bytes, dtype=torch.uint8, device=dev)
    selector = (ctypes.c_int * 2)()
    _lib.check(lib.harkdb_radix_sort_pairs(
        word.data_ptr(), word_alt.data_ptr(), values.data_ptr(),
        values_alt.data_ptr(), n, key_bytes, bits, temp.data_ptr(),
        temp_bytes, selector, _lib.stream_handle(dev),
    ), "radix sort")
    LAUNCHES += 1
    return ((word, word_alt)[selector[0]], (values, values_alt)[selector[1]])


def sort_pairs_reference(word: torch.Tensor, bits: int, values: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`sort_pairs`: one stable
    ``torch.sort`` of the word's low ``bits`` bits as an unsigned number
    (a full-width word with its sign bit flipped, so that signed order is
    unsigned order), then the word and values gathered through its order.
    Leaves its inputs as they are."""
    _check_pairs(word, bits, values)
    if bits == 8 * word.element_size():
        order_key = word ^ torch.iinfo(word.dtype).min
    else:
        order_key = word & ((1 << bits) - 1)
    order = torch.sort(order_key, stable=True).indices
    return word.index_select(0, order), values.index_select(0, order)
