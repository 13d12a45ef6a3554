"""Engine configuration.

A small frozen dataclass carries every tunable: dtype policy, capacity
bucketing for padded outputs and reference-parity switches. Env-var
overrides (``HARKDB_*``) exist for benchmark sweeps.

There is no kernel on/off switch: which version of a kernel runs is decided
by the tensor's device (a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain PyTorch version — see ``harkdb_tpu_torch.kernels``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env(name: str, cast, default):
    raw = os.environ.get(f"HARKDB_{name}")
    if raw is None:
        return default
    return cast(raw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All engine tunables. Immutable; pass a replaced copy to change."""

    # ---- dtype policy -------------------------------------------------------
    # Reference kernels use i32 for select (select.fut:23) and u32 for groupby
    # (groupby.fut:51); we normalize to int32 + float32 with explicit casts.
    int_dtype: str = "int32"
    float_dtype: str = "float32"

    # ---- padded-capacity management ------------------------------------------
    # Row counts are padded up to a multiple of `row_align`; data-dependent
    # output capacities are bucketed to powers of two of at least this size.
    row_align: int = 1024
    # After a filter-pushdown compaction on a single-table query, slice the
    # working capacity down to the live row count (power-of-two bucket)
    # before phase B — its sorts then run over the SURVIVORS, not the input
    # capacity, for one n_valid host readback. Engaged only at or above
    # this capacity so small queries skip the sync.
    shrink_rows_min: int = 1 << 22

    # ---- distribution -------------------------------------------------------
    # Name of the mesh's one axis, kept from the JAX package (where it names
    # the ``jax.sharding.Mesh`` axis). A process group has no named axes:
    # make_engine_mesh refuses any other value rather than ignore it.
    mesh_axis: str = "shards"
    # Number of ranks the mesh must have; None = the process group's size.
    num_shards: Optional[int] = None
    # Skew handling: a probe key whose local count exceeds `skew_threshold`
    # x (local rows / D) is nominated hot and salted over all ranks
    # (parallel/skew.py).
    skew_threshold: float = 0.25
    # Salted repartitioning for distributed joins (parallel/skew.py).
    skew_salted_join: bool = True
    # Run the post-aggregation / post-join tail (HAVING / ORDER BY /
    # OFFSET / LIMIT / projection / DISTINCT) sharded, with a range-
    # partitioned distributed sort, instead of gathering the whole result
    # on every rank before run_tail (parallel/executor.py).
    dist_tail: bool = True

    # ---- reference-parity compat ---------------------------------------------
    # The reference's groupby orders output keys by u32 bit pattern (radix
    # sort, groupby.fut:21-22), which puts NEGATIVE keys after positive ones.
    # This engine defaults to signed-ascending order (identical for the
    # non-negative keys the reference's tables use); set True to reproduce
    # the reference's u32 order exactly.
    compat_u32_key_order: bool = False

    # ---- observability / safety ---------------------------------------------
    collect_metrics: bool = True
    log_level: str = "WARNING"
    # Validate engine invariants (ColumnBatch capacity / n_valid) at the
    # planner's operator boundaries (utils/checks.py); each check reads
    # n_valid back to the host.
    debug_checks: bool = False
    # Re-execute a query once from resident tables on a transient device
    # failure (queries are pure).
    retry_on_failure: bool = True

    @staticmethod
    def from_env() -> "EngineConfig":
        base = EngineConfig()
        return dataclasses.replace(
            base,
            int_dtype=_env("INT_DTYPE", str, base.int_dtype),
            float_dtype=_env("FLOAT_DTYPE", str, base.float_dtype),
            row_align=_env("ROW_ALIGN", int, base.row_align),
            num_shards=_env("NUM_SHARDS", int, base.num_shards),
            log_level=_env("LOG_LEVEL", str, base.log_level),
        )

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig.from_env()
