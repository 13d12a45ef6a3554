from harkdb_tpu_torch.prims.segmented import (
    doubling_segmented_scan, replicated_iota, segmented_iota,
)
from harkdb_tpu_torch.prims.compaction import (
    compact_arrays, compact_batch, compact_indices,
)

__all__ = ["doubling_segmented_scan", "replicated_iota", "segmented_iota",
           "compact_arrays", "compact_batch", "compact_indices"]
