from harkdb_tpu_torch.ops.sort import sort_permutation, sort_batch
from harkdb_tpu_torch.ops.groupby import (
    groupby_aggregate, groupby_batch, AGG_FUNCS,
)
from harkdb_tpu_torch.ops.join import (
    inner_join_indices, join_indices, join_batches, join_match_count,
)

# The JAX package's names (``harkdb_tpu.ops.__all__``), then the port's own.
__all__ = [
    "sort_permutation",
    "sort_batch",
    "groupby_aggregate",
    "AGG_FUNCS",
    "inner_join_indices",
    "join_indices",
    "join_match_count",
    "join_batches",
    "groupby_batch",
]
