"""Distributed execution on ``torch.distributed``: one process per rank,
each holding its chunk of every table (counterpart of
``harkdb_tpu.parallel``). Importing this package starts nothing; a process
group comes from torchrun or :func:`multihost.init_multihost`."""

from harkdb_tpu_torch.parallel.mesh import EngineMesh, make_engine_mesh
from harkdb_tpu_torch.parallel.sharded import ShardedBatch, shard_batch
from harkdb_tpu_torch.parallel.shuffle import (
    hash_to_bucket, repartition_by_key,
)

__all__ = [
    "EngineMesh", "make_engine_mesh", "ShardedBatch", "shard_batch",
    "repartition_by_key", "hash_to_bucket",
]
