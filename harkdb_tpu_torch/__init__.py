"""harkdb_tpu_torch: the hark-tpu SQL engine on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``harkdb_tpu`` (JAX/XLA/Pallas), which stays the reference the
port is held against. The surface is the same BlazingSQL-style
``Context`` (``create_table`` / ``drop_table`` / ``sql`` / ``sql_df`` /
``explain`` / views / ``save`` / ``load``), with the device chosen
explicitly: ``Context(device="cuda")`` (the default) or ``"cpu"``.

This package imports torch and numpy, never jax: framework-free modules of
the JAX package (SQL parser, plan-time rewrites, ingest, the native CSV
loader, persistence) are copied here, not imported. It runs every
single-device feature of the JAX package: WHERE, GROUP BY with every
aggregate, HAVING, DISTINCT, ORDER BY, OFFSET, LIMIT, joins, derived tables,
CTEs and views, subqueries, set operations, window functions, strings,
``Context.profile``, ``EngineConfig.debug_checks`` and the CLI
(``python -m harkdb_tpu_torch``). Four kernels are written by hand for the
card: stream compaction (``kernels/compact.py``), segmented scan
(``kernels/segscan.py``), segment expansion (``kernels/expand.py``) and the
dense-key GROUP BY (``kernels/matmul_agg.py``). ``Context(mesh=...)`` runs
queries over several ranks of a ``torch.distributed`` process group
(``parallel/``), every feature above included.
"""

from harkdb_tpu_torch.config import EngineConfig
from harkdb_tpu_torch.columnar.table import Table, tables_from_reference
from harkdb_tpu_torch.api import Context

# BlazingSQL/HarkDB-compatible alias (reference FutharkContext.py:38).
FutharkContext = Context

__version__ = "0.1.0"

__all__ = ["Context", "FutharkContext", "Table", "EngineConfig",
           "tables_from_reference", "__version__"]
