"""harkdb_tpu_torch's distributed windows vs harkdb_tpu's, on the CPU.

The mesh cases of tests/test_windows.py, with the same tables from the
same seeds: ``TestWindowsDistributed.test_matches_single_chip`` (partitioned
windows, two PARTITION BY shapes chained, global windows on the carry path
with lag / lead through the halo), ``TestFrameSpecs.
test_frame_distributed_parity`` (a partitioned ROWS frame, and a global one
on the rank-0 route), and the ``test_distributed_parity`` cases of
``TestWindowsOverGroupedOutput``, ``TestPositionalWindowFuncs`` and
``TestFramesFollowing``. The port runs in a pool of 4 gloo ranks
(``torch_mesh_pool``); every rank's ``sql_df`` frame must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s: integers bit for bit,
NULLs in the same places, and the float columns (``avg`` outputs and the
global window's running float sums, which add in another order than on
one device) within rtol 1e-6.

Beside them, the modules against their JAX functions on the same sharded
inputs: ``dist_window`` rank by rank (the exchange puts the same rows in
the same order on rank i as JAX's shuffle on shard i), and
``dist_global_window`` in global order, each rank's capacity at most
4·n/D (the analog of ``TestGlobalWindowSharded.test_no_shard_funnel``)
and its running sum equal to numpy's.
"""

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from harkdb_tpu.parallel import shard_batch as jax_shard_batch
from harkdb_tpu.parallel.dist_ops import dist_window as jax_dist_window
from harkdb_tpu.parallel.global_window import (
    dist_global_window as jax_dist_global_window,
)
from harkdb_tpu.plan.windows import validity_names
from torch_mesh_pool import assert_same, assert_values, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def check(pool, jmesh, tables, queries, cfg=None):
    expect = jax_sql(jmesh, tables, queries, cfg, frames=True)
    assert all(e[0] == "ok" for e in expect), expect
    assert_same(expect, pool.run("run_sql", tables, queries, cfg, True),
                queries)


def _emp():
    """``TestWindowsDistributed.test_matches_single_chip``'s table."""
    rng = np.random.default_rng(0)
    return {"emp": pd.DataFrame({
        "dept": rng.choice(["eng", "ops", "hr", "sales"], 300),
        "pay": rng.integers(50, 150, 300).astype(np.int32),
        "yr": rng.integers(2018, 2023, 300).astype(np.int32),
    })}


WINDOW_QUERIES = [
    "select dept, pay, rank() over "
    "(partition by dept order by pay desc) as rk from emp "
    "order by dept, pay",
    "select dept, sum(pay) over (partition by dept) as tot, "
    "row_number() over (partition by yr order by pay) as rn from emp",
    "select pay, sum(pay) over () as tot from emp where pay > 80",
    "select dept, pay, sum(pay) over "
    "(partition by dept order by pay) as rs from emp "
    "order by rs desc limit 10",
    "select dept, pay, lead(pay, 1, -999) over "
    "(partition by dept order by pay) as nx from emp "
    "order by dept, pay",
    "select pay, row_number() over (order by pay desc, yr) as rn, "
    "rank() over (order by pay desc) as rk, "
    "dense_rank() over (order by pay desc) as dr from emp "
    "order by rn",
    "select pay, sum(pay) over (order by pay, yr) as rs, "
    "count(pay) over (order by pay, yr) as rc, "
    "min(pay) over (order by pay desc) as mn from emp "
    "order by pay, yr",
    "select pay, first_value(pay) over (order by pay desc) as fv, "
    "last_value(pay) over (order by pay) as lv from emp "
    "order by pay, yr limit 20",
    "select pay, sum(pay) over () as t, count(pay) over () as c, "
    "max(pay) over () as mx from emp where pay > 70 order by pay, yr",
    "select pay, lag(pay, 1, -3) over (order by pay, yr) as lg "
    "from emp order by pay, yr",
    "select pay, lead(pay, 3, -9) over (order by pay desc, yr) as ld, "
    "lag(yr, 2) over (order by pay desc, yr) as lg2 "
    "from emp order by pay desc, yr",
]


@pytest.mark.parametrize("qi", range(len(WINDOW_QUERIES)))
def test_windows_distributed_match_jax(pool, jmesh, qi):
    """tests/test_windows.py ``TestWindowsDistributed``'s queries."""
    check(pool, jmesh, _emp(), [WINDOW_QUERIES[qi]])


def test_frame_distributed_parity(pool, jmesh):
    """A partitioned ROWS frame, and a global one (the rank-0 route)."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "dept": rng.choice(["a", "b", "c"], 300),
        "pay": rng.integers(0, 200, 300).astype(np.int32),
    })
    check(pool, jmesh, {"emp": df}, [
        "select dept, pay, sum(pay) over (partition by dept "
        "order by pay rows between 3 preceding and current row) as s "
        "from emp order by dept, pay",
        "select pay, max(pay) over (order by pay "
        "rows between 2 preceding and current row) as m "
        "from emp order by pay",
    ])


def test_grouped_output_distributed_parity(pool, jmesh):
    """Windows over grouped output: a global rank over sum(...), and a
    partitioned row_number after HAVING."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "dept": rng.choice(["a", "b", "c", "d"], 600),
        "reg": rng.choice(["x", "y", "z"], 600),
        "pay": rng.integers(1, 100, 600).astype(np.int32),
    })
    check(pool, jmesh, {"emp": df}, [
        "select dept, reg, sum(pay) as tot, "
        "rank() over (order by sum(pay) desc) as rk "
        "from emp group by dept, reg order by rk, dept, reg",
        "select dept, reg, count(*) as n, row_number() over "
        "(partition by dept order by count(*) desc, reg) as rn "
        "from emp group by dept, reg having count(*) > 20 "
        "order by dept, rn",
        # a window argument over avg (a post-aggregation column), floats
        "select dept, avg(pay) as a, rank() over (order by avg(pay) desc) "
        "as rk from emp group by dept order by rk, dept",
    ])


def test_positional_distributed_parity(pool, jmesh):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "k": rng.choice(["a", "b", "c"], 200),
        "t": np.arange(200, dtype=np.int32),
        "v": rng.integers(0, 100, 200).astype(np.int32),
    })
    check(pool, jmesh, {"s": df}, [
        "select k, t, lag(v) over (partition by k order by t) as p, "
        "first_value(v) over (partition by k order by t) as fv "
        "from s order by k, t",
    ])


def test_frames_following_distributed_parity(pool, jmesh):
    """FOLLOWING bounds, NTILE / NTH_VALUE and a shifted frame whose empty
    windows are NULL."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "k": rng.integers(0, 6, 120).astype(np.int32),
        "v": rng.integers(0, 100, 120).astype(np.int32),
    })
    check(pool, jmesh, {"t": df}, [
        "select k, v, sum(v) over (partition by k order by v, k rows "
        "between 1 preceding and 2 following) as s from t "
        "order by k, v",
        "select k, v, ntile(3) over (partition by k order by v, k) "
        "as nt, nth_value(v, 2) over (partition by k order by v, k) "
        "as n2 from t order by k, v",
        "select k, v, sum(v) over (partition by k order by v, k rows "
        "between 2 following and 4 following) as s2 from t "
        "order by k, v",
    ])


def test_global_window_functions_parity(pool, jmesh):
    """Every function of the carry path over one global ORDER BY (the
    float ``avg`` and ``percent_rank`` / ``cume_dist`` at rtol 1e-6), the
    carry path without ORDER BY, and a lag wider than a rank's rows
    (the halo reads across several ranks)."""
    check(pool, jmesh, _emp(), [
        "select pay, yr, ntile(7) over (order by pay, yr) as nt, "
        "percent_rank() over (order by pay) as pr, "
        "cume_dist() over (order by pay) as cd, "
        "avg(pay) over (order by pay, yr) as av, "
        "prod(yr % 3 + 1) over (order by pay, yr) as pp, "
        "max(yr) over (order by pay) as mx from emp order by pay, yr",
        "select pay, first_value(yr) over () as fv, "
        "last_value(yr) over () as lv, avg(pay) over () as av, "
        "rank() over () as rk from emp where yr > 2019 order by pay, yr",
        "select pay, yr, lag(yr, 130, -1) over (order by pay, yr) as l130, "
        "lead(yr, 100) over (order by pay, yr) as d100 from emp "
        "where pay > 60 order by pay, yr",
    ])


def test_windows_gather_tail_parity(pool, jmesh):
    """With ``dist_tail=False`` the windowed rows are gathered and sorted
    back by row id before the plan's own tail; grouped windows then run on
    the gathered groups."""
    check(pool, jmesh, _emp(), [WINDOW_QUERIES[1], WINDOW_QUERIES[6],
                                "select dept, sum(pay) as s, rank() over "
                                "(order by sum(pay) desc) as rk from emp "
                                "group by dept"],
          cfg={"dist_tail": False})


# -- the modules against their JAX functions -----------------------------------

def _jax_blocks(sb):
    counts = np.asarray(sb.shard_counts)
    C = sb.local_capacity
    return [{n: np.asarray(c).reshape(D, C)[i, :counts[i]]
             for n, c in sb.columns.items()} for i in range(D)]


def _module_input(jmesh, tables, sql, table):
    ctx = harkdb_tpu.Context()
    for name, src in tables.items():
        ctx.create_table(name, src)
    plan = ctx._plan(sql)
    t = tables[table]
    n = len(next(iter(t.values())))
    host = {f"{table}.{c}": np.asarray(v) for c, v in t.items()}
    host[f"#rid.{table}"] = np.arange(n, dtype=np.int32)
    return plan, jax_shard_batch(host, n, jmesh), n


def test_dist_window_module_matches_jax(pool, jmesh):
    """``dist_window`` over one PARTITION BY shape: rank i's rows, in
    order, with every window column, equal JAX's shard i."""
    rng = np.random.default_rng(3)
    n = 5000
    tables = {"t": {"k": rng.integers(0, 40, n).astype(np.int32),
                    "v": rng.integers(-500, 500, n).astype(np.int32)}}
    sql = ("select k, v, row_number() over (partition by k order by v) as "
           "rn, sum(v) over (partition by k order by v) as s, avg(v) over "
           "(partition by k) as a, lag(v, 2) over (partition by k order by "
           "v) as lg from t")
    plan, sb, _n = _module_input(jmesh, tables, sql, "t")
    specs = plan.window_specs
    out = jax_dist_window(
        sb, specs[0][3], lambda b: plan._compute_windows(b, specs)[0],
        [s[0] for s in specs] + validity_names(specs), jmesh)
    expect = _jax_blocks(out)
    got = pool.run("window_blocks", tables, sql, "t", "partitioned")
    for rank, (blocks, _cap) in enumerate(got):
        assert sorted(blocks) == sorted(expect[rank]), rank
        for name, e in expect[rank].items():
            assert_values(e, blocks[name], f"rank {rank} {name}")


def test_dist_global_window_module_matches_jax(pool, jmesh):
    """``dist_global_window``: the rows in global order with every window
    column equal JAX's, each rank's capacity at most 4·n/D, and the
    running sum (the SQL default frame takes the whole tie run) equal to
    numpy's."""
    rng = np.random.default_rng(4)
    n = 1 << 14
    tables = {"t": {"v": rng.integers(-100, 100, n).astype(np.int32)}}
    sql = ("select v, sum(v) over (order by v) as s, row_number() over "
           "(order by v) as rn, dense_rank() over (order by v) as dr, "
           "count(v) over (order by v) as c, lag(v, 3, -1) over (order by "
           "v) as lg, lead(v, 700) over (order by v) as ld from t")
    plan, sb, _n = _module_input(jmesh, tables, sql, "t")
    out = jax_dist_global_window(sb, plan.window_specs, jmesh)
    expect = {name: np.concatenate([b[name] for b in _jax_blocks(out)])
              for name in out.columns}
    got = pool.run("window_blocks", tables, sql, "t", "global")
    for _blocks, cap in got:
        assert cap <= (n // D) * 4, cap
    for name, e in expect.items():
        g = np.concatenate([blocks[name] for blocks, _cap in got])
        assert_values(e, g, name)
    vs = np.sort(tables["t"]["v"])
    cs = np.cumsum(vs.astype(np.int64)).astype(np.int32)
    run_last = pd.DataFrame({"v": vs, "cs": cs}).groupby("v")["cs"] \
        .transform("last").to_numpy()
    s_name = plan.window_specs[0][0]
    np.testing.assert_array_equal(
        np.concatenate([blocks["t.v"] for blocks, _c in got]), vs)
    np.testing.assert_array_equal(
        np.concatenate([blocks[s_name] for blocks, _c in got]), run_last)
