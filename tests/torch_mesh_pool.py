"""A pool of gloo ranks on the CPU for harkdb_tpu_torch's distributed tests.

``MeshPool(n)`` spawns n processes that join one gloo process group through
``harkdb_tpu_torch.parallel.multihost.init_multihost`` (``device="cpu"``,
one thread each) and wait for tasks. ``pool.run(fn, *args)`` sends the same
task to every rank and returns each rank's result in rank order: ``fn``
names a function of this module, called as ``fn(mesh, *args)`` on every
rank. A rank's exception comes back as :class:`RankError`. Every call has
its own timeout: when it runs out the pool is killed and the call raises
``TimeoutError``, so a rank that hangs fails its test within seconds, not
at the suite's limit. ``shared_pool(n)`` is one such pool per test
process, shared by the test modules.

The workers import torch, numpy and harkdb_tpu_torch only (pandas when a
task carries a DataFrame), never jax or harkdb_tpu.
"""

from __future__ import annotations

import atexit
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Dict, List

import numpy as np

#: Seconds a pool call may take before the pool is killed.
CALL_TIMEOUT_S = 120.0


class RankError(Exception):
    """What a rank raised: its type name, message and traceback."""

    def __init__(self, rank: int, kind: str, message: str, trace: str):
        super().__init__(f"rank {rank}: {kind}: {message}\n{trace}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(rank, size, coordinator, timeout_s, tasks, results) -> None:
    import torch

    torch.set_num_threads(1)
    from harkdb_tpu_torch.parallel.multihost import init_multihost

    mesh = init_multihost(coordinator, size, rank, backend="gloo",
                          device="cpu", timeout_s=timeout_s)
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args = task
        try:
            results.put((rank, True, globals()[name](mesh, *args)))
        except Exception as e:                      # reported to the test
            results.put((rank, False, (type(e).__name__, str(e),
                                       traceback.format_exc())))
    import torch.distributed as dist

    dist.destroy_process_group()


class MeshPool:
    """``size`` gloo ranks on the CPU, alive until :meth:`close`."""

    def __init__(self, size: int = 4, collective_timeout_s: float = 60.0,
                 call_timeout_s: float = CALL_TIMEOUT_S):
        ctx = multiprocessing.get_context("spawn")
        coordinator = f"127.0.0.1:{_free_port()}"
        self.size = size
        self.call_timeout_s = call_timeout_s
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, daemon=True, args=(
                r, size, coordinator, collective_timeout_s, self._tasks[r],
                self._results))
            for r in range(size)
        ]
        for p in self._procs:
            p.start()

    def run(self, name: str, *args, timeout_s: float = None) -> List:
        """Every rank's ``name(mesh, *args)``, in rank order."""
        if not self._procs:
            raise RuntimeError("the pool was closed")
        for q in self._tasks:
            q.put((name, args))
        deadline = time.monotonic() + (timeout_s or self.call_timeout_s)
        out: Dict[int, object] = {}
        errors = []
        while len(out) + len(errors) < self.size:
            try:
                rank, ok, value = self._results.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(
                    f"{name}: ranks {sorted(set(range(self.size)) - set(out))}"
                    f" gave no answer in time; the pool was killed") from None
            if ok:
                out[rank] = value
            else:
                errors.append(RankError(rank, *value))
        if errors:
            raise errors[0]
        return [out[r] for r in range(self.size)]

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        self._procs = []


_SHARED: Dict[int, MeshPool] = {}


def shared_pool(size: int) -> MeshPool:
    """This process's pool of ``size`` ranks, started on first use and
    shared by every test module that asks (a pool takes seconds to start;
    its tasks keep no state between calls). A pool killed by a call that
    timed out is replaced."""
    pool = _SHARED.get(size)
    if pool is None or not pool._procs:
        pool = _SHARED[size] = MeshPool(size)
    return pool


@atexit.register
def _close_shared() -> None:
    for pool in _SHARED.values():
        pool.close(kill=True)


# -- tasks (run on every rank) ------------------------------------------------

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_sql(mesh, tables, queries, cfg=None, frames=False,
            capacities=False, views=None):
    """Each query through ``Context(mesh=mesh)``: ``("ok", result,
    last_fast_span, probed span)`` or ``("err", type name, message)``.
    ``views`` (name → SELECT) are created after the tables.
    ``frames`` gives ``sql_df``'s frame instead of ``sql``'s matrix;
    ``capacities`` adds ``last_tail_capacities`` (the ``DistExecutor``'s,
    or the one the sharded UNION tail leaves on the ``UnionPlan``)."""
    from harkdb_tpu_torch import Context, EngineConfig
    from harkdb_tpu_torch.parallel.executor import DistExecutor, run_on_mesh
    from harkdb_tpu_torch.plan.union_plan import UnionPlan

    config = EngineConfig(**(cfg or {}))
    ctx = Context(config, mesh=mesh)
    for name, src in tables.items():
        ctx.create_table(name, src)
    for name, body in (views or {}).items():
        ctx.create_view(name, body)
    out = []
    for q in queries:
        try:
            res = ctx.sql_df(q) if frames else ctx.sql(q)
        except Exception as e:
            out.append(("err", type(e).__name__, str(e)))
            continue
        plan = ctx._plan(q)
        entry = ["ok", res, getattr(plan, "last_fast_span", None),
                 getattr(plan, "_probed_fast_dist", None)]
        if capacities:
            if isinstance(plan, UnionPlan):
                ex = plan
                run_on_mesh(plan, ctx.tables, mesh, config,
                            ctx._shard_cache)
            else:
                ex = DistExecutor(plan, mesh, config,
                                  shard_cache=ctx._shard_cache)
                ex.execute(ctx.tables)
            entry.append(ex.last_tail_capacities)
        out.append(tuple(entry))
    return out


def shard_block(mesh, host_cols, n_rows, cfg=None):
    """This rank's block of ``shard_batch``: (columns, count)."""
    from harkdb_tpu_torch import EngineConfig
    from harkdb_tpu_torch.parallel.sharded import shard_batch

    sb = shard_batch(host_cols, n_rows, mesh, EngineConfig(**(cfg or {})))
    return {n: _np(c) for n, c in sb.columns.items()}, int(sb.count)


def sharded_accessors(mesh, host_cols, n_rows):
    """``ShardedBatch``'s accessors on this rank, for ``shard_batch``'s
    block and for ``dist_orderby``'s output over the first column (as
    tests/test_dist_tail.py reads them): ``n_shards``,
    ``global_capacity``, ``total_rows``, this rank's local capacity, and
    ``to_batch``'s whole columns (padding included) and count."""
    from harkdb_tpu_torch.parallel.dist_ops import dist_orderby
    from harkdb_tpu_torch.parallel.sharded import shard_batch

    sb = shard_batch(host_cols, n_rows, mesh)
    first = next(iter(host_cols))
    out = {}
    for name, b in (("sharded", sb), ("ordered", dist_orderby(
            sb, lambda cols, cap: [cols[first]], [False], mesh))):
        batch = b.to_batch(mesh)
        out[name] = (b.n_shards(mesh), b.global_capacity(mesh),
                     int(b.total_rows(mesh)), b.local_capacity,
                     {n: _np(c) for n, c in batch.columns.items()},
                     int(batch.n_valid))
    return out


def repartition(mesh, host_cols, key, n_rows):
    """``repartition_by_key`` of the sharded columns: this rank's live
    rows."""
    from harkdb_tpu_torch.parallel.sharded import shard_batch
    from harkdb_tpu_torch.parallel.shuffle import repartition_by_key

    sb = shard_batch(host_cols, n_rows, mesh)
    cols, n = repartition_by_key(sb.columns, key, sb.count, mesh)
    return {c: _np(v)[:int(n)] for c, v in cols.items()}


def orderby_head(mesh, v, offset=None, limit=None):
    """``dist_orderby`` (or ``dist_head`` when ``limit`` is given) of one
    int column: this rank's live block and local capacity."""
    from harkdb_tpu_torch.parallel.dist_ops import dist_head, dist_orderby
    from harkdb_tpu_torch.parallel.sharded import shard_batch

    sb = shard_batch({"v": v}, v.shape[0], mesh)
    if limit is None:
        out = dist_orderby(sb, lambda cols, cap: [cols["v"]], [False], mesh)
    else:
        out = dist_head(sb, offset, limit, mesh)
    return _np(out.columns["v"])[:int(out.count)], out.local_capacity


def _window_input(mesh, tables, sql, table):
    """``sql``'s single-device plan and this rank's block of ``table``
    (its columns as the plan names them, plus the row ids)."""
    from harkdb_tpu_torch import Context
    from harkdb_tpu_torch.parallel.sharded import shard_batch

    ctx = Context(device="cpu")
    for name, src in tables.items():
        ctx.create_table(name, src)
    plan = ctx._plan(sql)
    t = ctx.tables[table]
    host = {f"{table}.{c}": t.host_columns[c] for c in t.get_schema()}
    host[f"#rid.{table}"] = np.arange(t.n_rows, dtype=np.int32)
    return plan, shard_batch(host, t.n_rows, mesh)


def window_blocks(mesh, tables, sql, table, form):
    """The window specs of ``sql`` over ``table``'s sharded rows through
    ``dist_window`` (``form="partitioned"``: one PARTITION BY shape) or
    ``dist_global_window`` (``"global"``): this rank's live rows and
    local capacity."""
    from harkdb_tpu_torch.parallel.dist_ops import dist_window
    from harkdb_tpu_torch.parallel.global_window import dist_global_window
    from harkdb_tpu_torch.plan.windows import compute_windows

    plan, sb = _window_input(mesh, tables, sql, table)
    specs = plan.window_specs
    if form == "partitioned":
        out = dist_window(sb, specs[0][3],
                          lambda b: compute_windows(plan, b, specs)[0], mesh)
    else:
        out = dist_global_window(sb, specs, mesh)
    n = int(out.count)
    return {c: _np(v)[:n] for c, v in out.columns.items()}, out.local_capacity


def union_tail(mesh, tables, sql):
    """``parallel.executor.union_tail`` of ``sql`` over ``Context(mesh=...)``
    tables: the delivered live rows and ``last_tail_capacities``."""
    from harkdb_tpu_torch import Context
    from harkdb_tpu_torch.parallel.executor import union_tail

    ctx = Context(mesh=mesh)
    for name, src in tables.items():
        ctx.create_table(name, src)
    plan = ctx._plan(sql)
    b = union_tail(plan, ctx.tables, mesh, ctx.config, ctx._shard_cache)
    n = int(b.n_valid)
    return ({c: _np(v)[:n] for c, v in b.columns.items()},
            plan.last_tail_capacities)


def hot_keys(mesh, k, live=None, threshold=0.25):
    """``detect_hot_keys`` over this rank's block of ``k`` (its first
    ``live`` rows live when given): the valid candidates, sorted."""
    import torch

    from harkdb_tpu_torch.parallel.sharded import shard_batch
    from harkdb_tpu_torch.parallel.skew import detect_hot_keys

    if live is None:
        sb = shard_batch({"k": k}, k.shape[0], mesh)
        key, count = sb.columns["k"], sb.count
    else:
        C = k.shape[0] // mesh.size
        key = torch.from_numpy(k[mesh.rank * C:(mesh.rank + 1) * C].copy())
        count = torch.tensor(live, dtype=torch.int32)
    H, HV = detect_hot_keys(key, count, mesh.size, threshold, mesh)
    return sorted(_np(H)[_np(HV)].tolist())


def fail_or_hang(mesh, mode):
    """Rank 1 raises (``mode="raise"``) or sleeps (``"hang"``) while the
    other ranks enter an all_reduce."""
    import torch

    if mesh.rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 failed on purpose")
        time.sleep(3600)
    return int(mesh.all_reduce(torch.ones(1, dtype=torch.int64)))


def size_one_mesh(mesh, tables, query):
    """A mesh of one rank (a subgroup of this rank alone): the query's
    result, whether the Context ran it distributed, the mesh's size; and
    the error a mesh of more ranks than the group has raises."""
    import torch.distributed as dist

    from harkdb_tpu_torch import Context
    from harkdb_tpu_torch.parallel.mesh import make_engine_mesh

    groups = [dist.new_group([r]) for r in range(mesh.size)]
    one = make_engine_mesh(1, group=groups[mesh.rank], device="cpu")
    ctx = Context(mesh=one)
    for name, src in tables.items():
        ctx.create_table(name, src)
    res = ctx.sql(query)
    try:
        make_engine_mesh(mesh.size + 1, device="cpu")
        too_many = None
    except ValueError as e:
        too_many = str(e)
    return res, ctx.last_metrics.distributed, one.size, too_many


# -- the JAX side and the comparison (in the test process only) ---------------

def jax_sql(mesh, tables, queries, cfg=None, frames=False, views=None):
    """The same queries through ``harkdb_tpu.Context(mesh=mesh)`` (or the
    single-device path for ``mesh=None``), in :func:`run_sql`'s form."""
    import harkdb_tpu

    ctx = harkdb_tpu.Context(harkdb_tpu.EngineConfig(**(cfg or {})),
                             mesh=mesh)
    for name, src in tables.items():
        ctx.create_table(name, src)
    for name, body in (views or {}).items():
        ctx.create_view(name, body)
    out = []
    for q in queries:
        try:
            res = ctx.sql_df(q) if frames else ctx.sql(q)
        except Exception as e:
            out.append(("err", type(e).__name__, str(e)))
            continue
        plan = ctx._plan(q)
        out.append(("ok", res, getattr(plan, "last_fast_span", None),
                    getattr(plan, "_probed_fast_dist", None)))
    return out


def assert_values(expect, got, what: str) -> None:
    """Integers (and strings) bit for bit, floats within rtol 1e-6, NULLs
    (NaN / None) in the same places; matrices or frames."""
    import pandas as pd

    if isinstance(expect, pd.DataFrame):
        assert list(got.columns) == list(expect.columns), what
        assert len(got) == len(expect), (what, len(got), len(expect))
        for c in expect.columns:
            e, g = expect[c], got[c]
            assert (g.isna().to_numpy() == e.isna().to_numpy()).all(), (
                what, c)
            keep = ~e.isna().to_numpy()
            assert_values(e.to_numpy()[keep], g.to_numpy()[keep],
                          f"{what} [{c}]")
        return
    expect, got = np.asarray(expect), np.asarray(got)
    assert got.shape == expect.shape, (what, got.shape, expect.shape)
    if expect.dtype.kind == "f" or got.dtype.kind == "f":
        np.testing.assert_allclose(got.astype(np.float64),
                                   expect.astype(np.float64), rtol=1e-6,
                                   atol=0, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, expect, err_msg=what)


def assert_same(expect, got, queries) -> None:
    """Every rank's :func:`run_sql` entries against JAX's: the same result
    or the same error text, and the same dense-path plan fields."""
    for rank, entries in enumerate(got):
        for q, e, g in zip(queries, expect, entries):
            what = f"rank {rank}: {q}"
            if e[0] == "err":
                assert tuple(g[:3]) == tuple(e[:3]), what
                continue
            assert g[0] == "ok", (what, g)
            assert_values(e[1], g[1], what)
            assert g[2] == e[2], (what, "last_fast_span", g[2], e[2])
            assert g[3] == e[3], (what, "probed span", g[3], e[3])


def multihost_worker(fn, coordinator, num_processes, rank, results) -> None:
    """Process target: ``harkdb_tpu_torch.parallel.multihost.<fn>`` as one
    rank; puts ``(rank, its return value or the error's text)``."""
    import torch

    torch.set_num_threads(1)
    from harkdb_tpu_torch.parallel import multihost

    try:
        results.put((rank, getattr(multihost, fn)(coordinator, num_processes,
                                                  rank, device="cpu")))
    except Exception as e:                          # reported to the test
        results.put((rank, f"{type(e).__name__}: {e}"))
