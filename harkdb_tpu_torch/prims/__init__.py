from harkdb_tpu_torch.prims.segmented import (
    doubling_segmented_scan,
    segmented_scan,
    segmented_reduce,
    replicated_iota,
    segmented_iota,
    expand,
    expand_reduce,
    expand_outer_reduce,
)
from harkdb_tpu_torch.prims.compaction import (
    compact_indices,
    compact,
    compact_batch,
    compact_arrays,
)

# The JAX package's ten names (``harkdb_tpu.prims.__all__``), then the
# port's own.
__all__ = [
    "segmented_scan",
    "segmented_reduce",
    "replicated_iota",
    "segmented_iota",
    "expand",
    "expand_reduce",
    "expand_outer_reduce",
    "compact_indices",
    "compact",
    "compact_batch",
    "doubling_segmented_scan",
    "compact_arrays",
]
