"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors; nothing is built or loaded at import.
"""

from harkdb_tpu_torch.kernels.matmul_agg import (
    onehot_groupby_sums, matmul_agg_applicable,
)

__all__ = ["onehot_groupby_sums", "matmul_agg_applicable"]
