"""Starting ranks: ``torch.distributed`` process groups for the engine.

Counterpart of ``harkdb_tpu.parallel.multihost``. JAX joins processes
with ``jax.distributed.initialize`` and then builds one global mesh; here
each process joins a process group and is one rank of the mesh
(``init_multihost``), or is started by torchrun, which sets the
environment :func:`init_from_env` reads.

The multi-process contract is JAX's (``harkdb_tpu/parallel/multihost.py:
15-23``): every control value a host decision reads is all-reduced or
all-gathered first, and delivery is an all_gather, so every process
returns the whole result. :func:`worker_demo` and :func:`worker_sql` drive
the shuffle and a full SQL query across the process boundary and check
them (``tests/test_torch_parallel.py`` runs them as two CPU processes).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from harkdb_tpu_torch.parallel.mesh import EngineMesh, make_engine_mesh

#: How long a collective waits for the other ranks before it raises: a rank
#: that stops fails the others within this many seconds instead of hanging.
DEFAULT_TIMEOUT_S = 60.0


def _default_backend(device: torch.device, ranks_here: int) -> str:
    """NCCL when every rank on this host can have a card of its own, else
    gloo (the CPU, or several ranks sharing one card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_here:
        return "nccl"
    return "gloo"


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: Optional[str] = None, device=None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> EngineMesh:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``; returns this rank's mesh (``make_engine_mesh``).

    ``coordinator`` is ``host:port`` (``tcp://`` optional) of rank 0's
    store. ``device`` defaults to ``cuda:{process_id % cards}`` and raises
    when no card is visible (pass ``device="cpu"`` for the CPU);
    ``backend`` defaults to NCCL when every rank can have a card of its own
    and gloo otherwise, chosen here and never switched later. Collectives
    time out after ``timeout_s``.
    """
    if device is None:
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError(
                "init_multihost runs each rank on a CUDA device and none is "
                "visible; pass device=\"cpu\" to run the ranks on the CPU")
        device = f"cuda:{process_id % n}"
    device = torch.device(device)
    if backend is None:
        backend = _default_backend(device, num_processes)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not coordinator.startswith("tcp://"):
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return make_engine_mesh(num_processes, device=device)


def init_from_env(cpu: bool = False,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> EngineMesh:
    """Join the process group torchrun describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); the rank's
    device is the CPU with ``cpu``, else ``cuda:{LOCAL_RANK}``. Raises,
    naming torchrun, when the environment holds no launcher's settings."""
    missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                           "RANK") if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"a mesh needs one process per rank, and {', '.join(missing)} "
            f"{'is' if len(missing) == 1 else 'are'} not set: start the "
            f"ranks with torchrun (python -m torch.distributed.run "
            f"--nproc-per-node N -m harkdb_tpu_torch --mesh ...) or call "
            f"harkdb_tpu_torch.parallel.multihost.init_multihost in each"
        )
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cpu" if cpu else f"cuda:{local}")
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return init_multihost(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
        backend=_default_backend(device, ranks_here), device=device,
        timeout_s=timeout_s,
    )


def worker_demo(coordinator: str, num_processes: int, process_id: int,
                device=None) -> str:
    """Drive the engine's shuffle across a real process boundary.

    Each rank holds 256 rows of one table made from the same seed; the
    rows are hash-repartitioned with ``repartition_by_key`` (one exchange)
    and two invariants are all-reduced: no row lost, and every key's rows
    on the rank its hash names. Returns "OK <total>". ``device`` as
    :func:`init_multihost` takes it (a card unless ``"cpu"`` is asked for).
    """
    import numpy as np

    from harkdb_tpu_torch.parallel.sharded import shard_batch
    from harkdb_tpu_torch.parallel.shuffle import (
        hash_to_bucket, repartition_by_key,
    )

    mesh = init_multihost(coordinator, num_processes, process_id,
                          device=device)
    try:
        D, C = mesh.size, 256
        rng = np.random.default_rng(0)                 # same data everywhere
        keys = rng.integers(0, 40, D * C).astype(np.int32)
        vals = rng.integers(0, 1000, D * C).astype(np.int32)
        sb = shard_batch({"k": keys, "v": vals}, D * C, mesh)
        cols, n_out = repartition_by_key(sb.columns, "k", sb.count, mesh)
        live = torch.arange(cols["k"].shape[0],
                            device=mesh.device) < n_out
        owned = hash_to_bucket(cols["k"], D) == mesh.rank
        total, misrouted = mesh.all_reduce(torch.stack([
            n_out.to(torch.int64), (live & ~owned).sum()]), "sum").tolist()
        if total != D * C or misrouted:
            raise AssertionError(f"shuffle lost rows or misrouted keys: "
                                 f"{total} of {D * C}, {misrouted} misrouted")
        return f"OK {total}"
    finally:
        dist.destroy_process_group()


def worker_sql(coordinator: str, num_processes: int, process_id: int,
               device=None) -> str:
    """End-to-end SQL across a real process boundary: a join + WHERE +
    GROUP BY + HAVING + ORDER BY query, an ungrouped ORDER BY ... LIMIT and
    a DISTINCT run on the mesh, and every rank's whole result must equal
    the single-device answer bit for bit. ``device`` as
    :func:`init_multihost` takes it."""
    import numpy as np

    from harkdb_tpu_torch import Context, EngineConfig

    mesh = init_multihost(coordinator, num_processes, process_id,
                          device=device)
    try:
        cfg = EngineConfig(row_align=64)
        rng = np.random.default_rng(0)                 # same data everywhere
        n = 500
        facts = {"k": rng.integers(0, 9, n).astype(np.int32),
                 "v": rng.integers(-50, 50, n).astype(np.int32)}
        dims = {"j": np.arange(9, dtype=np.int32),
                "m": rng.integers(1, 5, 9).astype(np.int32)}
        dc = Context(cfg, mesh=mesh)
        sc = Context(cfg, device=mesh.device)          # single-device oracle
        for c in (dc, sc):
            c.create_table("facts", facts)
            c.create_table("dims", dims)
        queries = [
            "select k, sum(v), max(m), count(*) from facts "
            "join dims on facts.k = dims.j "
            "where v > -40 group by k having count(*) > 1 order by k",
            "select v, k from facts where v != 0 order by v desc, k limit 37",
            "select distinct k from facts order by k desc",
        ]
        for q in queries:
            got, expect = dc.sql(q), sc.sql(q)
            if got.shape != expect.shape or not np.array_equal(got, expect):
                raise AssertionError(f"rank {mesh.rank} differs: {q}")
        out = dc.sql(queries[0])
        return f"SQL OK {out.shape[0]}x{out.shape[1]}"
    finally:
        dist.destroy_process_group()
