"""Helpers the table generators share: seeded draws on one device, fixed
line counts per order, vocabulary columns, and the bytes of user data.

Every draw goes through one ``torch.Generator`` on the device that makes
the tables, so the same seed gives the same tables on that device. The
tables come back as host numpy arrays: the benchmark hands the same arrays
to the engine and to the plain reference.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Sequence

import numpy as np
import torch

EPOCH = _dt.date(1970, 1, 1)


def day_number(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date ``YYYY-MM-DD``."""
    return (_dt.date.fromisoformat(iso) - EPOCH).days


def add_months(iso: str, months: int) -> str:
    d = _dt.date.fromisoformat(iso)
    m = d.month - 1 + months
    return _dt.date(d.year + m // 12, m % 12 + 1, d.day).isoformat()


class Draws:
    """Seeded uniform draws on one device, int32 unless said otherwise."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    def ints(self, lo: int, hi: int, n: int) -> torch.Tensor:
        """``n`` integers uniform over ``[lo, hi]``, both ends included."""
        return torch.randint(lo, hi + 1, (n,), generator=self.gen,
                             device=self.device, dtype=torch.int32)

    def perm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device,
                              dtype=torch.int64)


def fixed_counts(n_groups: int, total: int, lo: int, hi: int) -> np.ndarray:
    """How many groups take each size in ``[lo, hi]``, as even as the sizes
    allow, with the sizes summing to exactly ``total``: every seed then
    gets the same set of sizes, in another order."""
    sizes = np.arange(lo, hi + 1)
    mid = sizes.size // 2
    hist = np.full(sizes.size, n_groups // sizes.size, np.int64)
    hist[mid] += n_groups - hist.sum()
    # move groups from the middle size one size down (or up) until the
    # sizes sum to ``total``
    excess = int((hist * sizes).sum()) - total
    dst = mid - 1 if excess > 0 else mid + 1
    if abs(excess) > hist[mid] or not 0 <= dst < sizes.size:
        raise ValueError(f"{total} does not split into {n_groups} groups "
                         f"of {lo}-{hi} this way")
    hist[mid] -= abs(excess)
    hist[dst] += abs(excess)
    return np.repeat(sizes, hist)


def group_sizes(draws: Draws, n_groups: int, total: int, lo: int,
                hi: int) -> torch.Tensor:
    """:func:`fixed_counts` in the seed's order, on the draws' device."""
    sizes = torch.from_numpy(fixed_counts(n_groups, total, lo, hi)).to(
        draws.device)
    return sizes[draws.perm(n_groups)]


def vocab(words: Sequence[str], codes: torch.Tensor) -> np.ndarray:
    """The strings ``words[codes]`` as a numpy string array."""
    return np.asarray(words)[codes.cpu().numpy()]


def host(cols: Dict[str, object]) -> Dict[str, np.ndarray]:
    """A table's columns as host numpy arrays, in order."""
    out = {}
    for name, c in cols.items():
        out[name] = c.cpu().numpy() if isinstance(c, torch.Tensor) else c
    return out


def data_bytes(tables: Dict[str, Dict[str, np.ndarray]]) -> int:
    """Bytes of user data: a numeric value's width, a string's UTF-8
    length (one byte a character: every generated string is ASCII)."""
    n = 0
    for cols in tables.values():
        for a in cols.values():
            if a.dtype.kind == "U":
                n += int(np.char.str_len(a).sum())
            else:
                n += a.nbytes
    return n
