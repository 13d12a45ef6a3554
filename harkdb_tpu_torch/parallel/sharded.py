"""ShardedBatch — this rank's block of a row-sharded relation.

Counterpart of ``harkdb_tpu.parallel.sharded``. In JAX a ShardedBatch is a
set of global ``(D * C,)`` arrays sharded row-wise over the mesh, plus the
per-shard counts; each device sees its own ``C``-row block under
``shard_map``. Here each rank holds only its own block: named 1-D columns
of a local capacity and the live count, a 0-d int32 tensor on the mesh's
device. Capacities may differ between ranks (nothing here needs static
shapes), and an exchange sizes its output to the rows that arrived.

Global row order convention, as in JAX: the live rows of rank i come
before those of rank i + 1, and ``shard_batch`` cuts a table into balanced
contiguous chunks, so concatenating the blocks in rank order gives the
table's row order. Rank i holds exactly JAX's shard i.

Columns cross the process boundary as one int32 word matrix per exchange
(:func:`word_columns`, :func:`pack_words`): 4-byte types as one word,
8-byte types as two, and narrower types widened, so one collective carries
every column of any dtype over gloo or NCCL.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from harkdb_tpu_torch.columnar.batch import ColumnBatch, align_capacity
from harkdb_tpu_torch.config import EngineConfig, DEFAULT_CONFIG
from harkdb_tpu_torch.prims.compaction import compact_arrays

#: A packed layout: (column name, dtype, words) per column, in order.
Layout = List[Tuple[str, torch.dtype, int]]


def pack_words(cols: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Layout]:
    """Every column as int32 words side by side: an ``(n, W)`` matrix and
    the layout :func:`unpack_words` restores the columns from."""
    words, layout = word_columns(cols)
    return torch.stack(words, 1), layout


def word_columns(cols: Dict[str, torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], Layout]:
    """:func:`pack_words`'s words as separate 1-D int32 columns."""
    words: List[torch.Tensor] = []
    layout: Layout = []
    for name, c in cols.items():
        size = c.element_size()
        if c.dtype == torch.bool or size < 4:
            ws = [c.to(torch.int32)]
        elif size == 4:
            ws = [c.view(torch.int32)]
        elif size == 8:
            ws = list(c.contiguous().view(torch.int32).view(-1, 2).unbind(1))
        else:
            raise TypeError(f"column {name!r} of unsupported dtype {c.dtype}")
        layout.append((name, c.dtype, len(ws)))
        words.extend(w.contiguous() for w in ws)
    return words, layout


def unpack_words(mat: torch.Tensor, layout: Layout
                 ) -> Dict[str, torch.Tensor]:
    """The columns :func:`pack_words` packed into ``mat``."""
    out, j = {}, 0
    for name, dtype, k in layout:
        w = mat[:, j:j + k]
        j += k
        if k == 2:
            out[name] = w.contiguous().view(dtype).view(-1)
        elif dtype == torch.bool or torch.empty((), dtype=dtype).element_size() < 4:
            out[name] = w[:, 0].to(dtype)
        else:
            out[name] = w[:, 0].contiguous().view(dtype)
    return out


def next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0) if n > 1 else 1


def block_capacity(rows: int) -> int:
    """Local capacity for ``rows`` live rows after an exchange or a shrink:
    a power of two of at least 128 (the JAX package's granule)."""
    return max(128, next_pow2(rows))


class ShardedBatch:
    """This rank's block: equal-length local columns plus the live count."""

    def __init__(self, columns: Dict[str, torch.Tensor], count: torch.Tensor):
        self.columns = dict(columns)
        self.count = count

    @property
    def local_capacity(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def n_shards(self, mesh) -> int:
        """The number of blocks: one per rank of ``mesh``."""
        return mesh.size

    def global_capacity(self, mesh) -> int:
        """The sum of every rank's local capacity (they may differ here)."""
        cap = torch.tensor(self.local_capacity, dtype=torch.int64,
                           device=self.count.device)
        return int(mesh.all_reduce(cap))

    def total_rows(self, mesh) -> torch.Tensor:
        """The live rows over every rank: the all-reduced sum of the
        counts, a 0-d int32 tensor on every rank."""
        return mesh.all_reduce(self.count)

    def to_batch(self, mesh) -> ColumnBatch:
        """The whole relation on every rank, packed in rank order (= the
        table's row order), padding rows zero: :meth:`to_batch_device` with
        its padding cleared, as JAX's host-driven ``to_batch`` pads."""
        batch = self.to_batch_device(mesh)
        live = batch.valid_mask()
        return batch.with_columns({
            n: torch.where(live, c, torch.zeros((), dtype=c.dtype,
                                                device=c.device))
            for n, c in batch.columns.items()})

    def to_batch_device(self, mesh) -> ColumnBatch:
        """The whole relation on every rank, in rank order (= the table's
        row order): one all_gather of the counts, one of the columns (each
        rank's first ``max(counts)`` rows as a word matrix), then kernel A
        packs the gaps between the blocks out."""
        counts = mesh.all_gather(self.count.reshape(1)).reshape(-1)
        m = max(1, int(counts.max()))
        names = self.names
        mat, layout = pack_words(
            {n: _fit(c, m) for n, c in self.columns.items()})
        g = mesh.all_gather(mat).reshape(mesh.size * m, -1)
        idx = torch.arange(mesh.size * m, dtype=torch.int32,
                           device=mat.device)
        live = (idx % m) < counts.to(torch.int32)[idx // m]
        total = counts.sum(dtype=torch.int32)
        packed, _n = compact_arrays(list(g.unbind(1)), live, total.new_full(
            (), mesh.size * m))
        cols = unpack_words(torch.stack(packed, 1), layout)
        return ColumnBatch({n: cols[n] for n in names}, total)


def _fit(col: torch.Tensor, m: int) -> torch.Tensor:
    """``col`` cut or zero-padded to ``m`` rows."""
    if col.shape[0] >= m:
        return col[:m]
    return torch.cat([col, col.new_zeros(m - col.shape[0])])


def shard_batch(host_cols: Dict[str, np.ndarray], n_rows: int, mesh,
                config: EngineConfig = DEFAULT_CONFIG) -> ShardedBatch:
    """This rank's chunk of host columns: D balanced contiguous row chunks,
    each padded to a common local capacity, placed on the mesh's device
    (``harkdb_tpu/parallel/sharded.py:126``: the same ``per``, capacity
    and counts, so rank i holds JAX's shard i)."""
    D, i = mesh.size, mesh.rank
    per = -(-n_rows // D) if n_rows else 0           # ceil
    C = align_capacity(per, max(config.row_align // D, 128))
    counts = np.clip(n_rows - per * np.arange(D), 0, per).astype(np.int32)
    c = int(counts[i])
    cols = {}
    for name, a in host_cols.items():
        a = np.asarray(a)
        buf = torch.zeros(C, dtype=torch.from_numpy(a[:0]).dtype,
                          device=mesh.device)
        buf[:c] = torch.from_numpy(np.ascontiguousarray(a[i * per: i * per + c]))
        cols[name] = buf
    return ShardedBatch(cols, torch.tensor(c, dtype=torch.int32,
                                           device=mesh.device))
