"""A cell on several cards: one process per card, joined over
``torch.distributed`` (NCCL on the cards, gloo on the CPU), with the
rendezvous file in the temporary directory.

Every rank makes the same tables from the seed, loads them into
``Context(mesh=...)`` and runs the same queries in the same order; rank
0's clock decides when the window closes (``harness.cell.CONTROL_GROUP``,
a gloo group), rank 0 times the queries and checks its answers against the
reference, and every other rank's answers must equal rank 0's.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import traceback

RANK_TIMEOUT_S = 1200.0


def _rank(rank, n, store, cell, seed, seconds, trace, t0, device,
          backend, scale, out):
    import sys

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [here, os.path.dirname(here)]
    try:
        import datetime

        import torch
        import torch.distributed as dist

        from harness import cell as cell_mod
        from harkdb_tpu_torch.parallel.mesh import make_engine_mesh

        dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        cell_mod.CONTROL_GROUP = dist.new_group(backend="gloo")
        mesh = make_engine_mesh(n, device=dev)
        run = cell_mod.run_cell(cell, seed, seconds, trace, t0,
                                device=dev.type, scale=scale, mesh=mesh,
                                check_answers=rank == 0)
        gathered = [None] * n if rank == 0 else None
        dist.gather_object(run.digests, gathered, dst=0,
                           group=cell_mod.CONTROL_GROUP)
        if rank == 0:
            differ = sum(a != b for other in gathered[1:]
                         for a, b in zip(run.digests, other))
            run.checks["wrong_answers"] += differ
            run.correct = run.correct and differ == 0
            run.digests = None
            out.put(("ok", run))
        dist.destroy_process_group()
    except BaseException:                   # reported to the parent, re-raised
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise


def run_ranks(cell: dict, seed: int, seconds: float, trace: bool,
              n: int, t0: float, device: str = "cuda",
              backend: str = "nccl", scale: float = 1.0):
    """Run the cell on ``n`` ranks and return rank 0's ``Run``."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="bench-ranks-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank, args=(
        r, n, store, cell, seed, seconds, trace, t0, device, backend,
        scale, out)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        try:
            status, payload = out.get(timeout=RANK_TIMEOUT_S)
        except queue.Empty:
            raise RuntimeError(f"no rank reported within {RANK_TIMEOUT_S} s")
        if status != "ok":
            raise RuntimeError(payload)
        return payload
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
