"""harkdb_tpu_torch's set operations, derived tables, CTEs and views on a
mesh vs harkdb_tpu's, on the CPU.

The mesh cases of tests/test_union.py (``TestUnionDistributed``:
``test_matches_single``, ``test_sharded_tail_matches_single``,
``test_string_union_distributed``), tests/test_sql_ext.py
(``TestSetOps.test_distributed_arms_gather_tail``,
``TestSetOpBodies.test_distributed_parity``, and TestSetOpBodies' other
queries: set-operation bodies of a derived table, a CTE, a view and an IN
subquery) and tests/test_derived.py (``TestDerivedDistributed``), with
the same tables from the same seeds. The port runs in a pool of 4 gloo
ranks (``torch_mesh_pool``); every rank's ``sql_df`` frame must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s: integers and strings
bit for bit, NULLs in the same places, the float column of the int /
float UNION (``avg(v)`` merged with an int column) within rtol 1e-6.

Beside them, the sharded UNION tail (the port's
``parallel.executor.union_tail``) against JAX's
(``UnionPlan._execute_sharded``) on the same tables, and the analog of
``test_union_all_memory_stays_sharded``: a UNION ALL of 2^16 rows keeps
every rank's capacity at every stage of the tail within 2/D of the
combined rows (``last_tail_capacities``).
"""

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from torch_mesh_pool import assert_same, assert_values, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def check(pool, jmesh, tables, queries, cfg=None, views=None, errors=0):
    """Every rank against JAX's mesh; JAX raises for the last ``errors``
    queries only (the port must raise the same text)."""
    expect = jax_sql(jmesh, tables, queries, cfg, True, views)
    kinds = [e[0] for e in expect]
    assert kinds == ["ok"] * (len(queries) - errors) + ["err"] * errors, \
        expect
    got = pool.run("run_sql", tables, queries, cfg, True, False, views)
    assert_same(expect, got, queries)


def test_union_matches_jax(pool, jmesh):
    """``TestUnionDistributed.test_matches_single``: UNION of two grouped
    arms."""
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"k": rng.integers(0, 5, 300).astype(np.int32),
                      "v": rng.integers(0, 100, 300).astype(np.int32)})
    b = pd.DataFrame({"k": rng.integers(3, 8, 300).astype(np.int32),
                      "v": rng.integers(0, 100, 300).astype(np.int32)})
    check(pool, jmesh, {"a": a, "b": b}, [
        "select k, sum(v) as s from a group by k "
        "union select k, sum(v) as s from b group by k order by k, s"])


def _ab():
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"k": rng.integers(0, 9, 400).astype(np.int32),
                      "v": rng.integers(0, 100, 400).astype(np.int32)})
    b = pd.DataFrame({"k": rng.integers(4, 12, 250).astype(np.int32),
                      "v": rng.integers(0, 100, 250).astype(np.int32)})
    return {"a": a, "b": b}


SHARDED_TAIL_QUERIES = [
    "select k, v from a union all select k, v from b",
    "select k, v from a union select k, v from b order by k, v",
    "select k, v from a where v > 40 union all select k, v from b "
    "order by v desc, k limit 17",
    "select k from a union select k from b union all select k from a "
    "order by k limit 10 offset 3",
    "select k, avg(v) as x from a group by k "
    "union all select k, v from b order by x, k limit 25",
]


@pytest.mark.parametrize("qi", range(len(SHARDED_TAIL_QUERIES)))
def test_sharded_tail_matches_jax(pool, jmesh, qi):
    """``TestUnionDistributed.test_sharded_tail_matches_single``'s
    queries (the last one merges a float and an int column)."""
    check(pool, jmesh, _ab(), [SHARDED_TAIL_QUERIES[qi]])


def test_union_gather_tail_matches_jax(pool, jmesh):
    """The same UNIONs with ``dist_tail=False``: arms delivered to every
    rank, combined locally; and the exact-integer span guard's error."""
    t = _ab()
    t["big"] = pd.DataFrame({"v": np.int32([1 << 25, 3])})
    t["fl"] = pd.DataFrame({"v": np.float32([0.5, 3.0])})
    queries = SHARDED_TAIL_QUERIES[1:4] + [
        "select v from big union all select v from fl"]
    check(pool, jmesh, t, queries, cfg={"dist_tail": False}, errors=1)
    check(pool, jmesh, t, queries[-1:], errors=1)


def test_string_union_distributed(pool, jmesh):
    rng = np.random.default_rng(0)
    s1 = pd.DataFrame({"s": rng.choice(["ant", "bee", "cat"], 200),
                       "n": rng.integers(0, 50, 200).astype(np.int32)})
    s2 = pd.DataFrame({"s": rng.choice(["bee", "dog", "elk"], 150),
                       "n": rng.integers(0, 50, 150).astype(np.int32)})
    check(pool, jmesh, {"s1": s1, "s2": s2}, [
        "select s, n from s1 union select s, n from s2 "
        "order by s, n limit 30"])


def test_setops_distributed_arms_gather_tail(pool, jmesh):
    """``TestSetOps.test_distributed_arms_gather_tail``: INTERSECT and
    EXCEPT take the gather path; and NULLs compare equal across arms."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"x": rng.integers(0, 40, 300).astype(np.int32)})
    u = pd.DataFrame({"y": rng.integers(20, 60, 200).astype(np.int32)})
    f = pd.DataFrame({"k": np.array([1, 2], np.int32)})
    d = pd.DataFrame({"j": np.array([1], np.int32),
                      "m": np.array([7], np.int32)})
    check(pool, jmesh, {"t": t, "u": u, "f": f, "d": d}, [
        "select x from t intersect select y from u order by x",
        "select x from t except select y from u order by x desc",
        "select x from t union select y from u "
        "except select x from t where x > 30 order by x",
        "select d.m from f left join d on f.k = d.j "
        "intersect select d.m from f left join d on f.k = d.j order by m",
        "select d.m from f left join d on f.k = d.j "
        "union select d.m from f left join d on f.k = d.j order by m",
    ])


def test_setop_bodies_distributed_parity(pool, jmesh):
    """``TestSetOpBodies.test_distributed_parity``, and its other bodies
    on the mesh: a derived UNION, a CTE INTERSECT, a view UNION ALL and
    an IN subquery over EXCEPT."""
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"x": rng.integers(0, 50, 400).astype(np.int32)})
    b = pd.DataFrame({"y": rng.integers(25, 75, 300).astype(np.int32)})
    check(pool, jmesh, {"a": a, "b": b}, [
        "select d.x, count(*) as n from "
        "(select x from a union all select y from b) d "
        "group by d.x order by d.x",
        "select d.x, count(*) as n from "
        "(select x from a union select y from b) d "
        "group by d.x order by d.x",
        "with u as (select x from a intersect select y from b) "
        "select * from u order by x",
        "select count(*) as n from uni",
        "select x from a where x in "
        "(select x from a except select y from b) order by x",
    ], views={"uni": "select x from a union all select y from b"})


def test_derived_distributed_matches_jax(pool, jmesh):
    """``TestDerivedDistributed.test_matches_single_chip``: a grouped
    derived table filtered, joined, and grouped again."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "k": rng.integers(0, 12, 400).astype(np.int32),
        "v": rng.integers(-50, 50, 400).astype(np.int32),
        "s": rng.choice(["ant", "bee", "cat", "elk"], 400),
    })
    dim = pd.DataFrame({"j": np.arange(12, dtype=np.int32),
                        "m": rng.integers(1, 9, 12).astype(np.int32)})
    check(pool, jmesh, {"t": df, "dim": dim}, [
        "select d.k, d.tot from (select k, sum(v) as tot from t "
        "group by k) d where d.tot > 0 order by d.tot desc, d.k",
        "select d.k, d.tot, dim.m from (select k, sum(v) as tot from t "
        "group by k) d join dim on d.k = dim.j order by d.k",
        "select u.s, count(*) as n from (select s, v from t "
        "where v > 0) u group by u.s order by u.s",
        # a CTE read twice, and a window over a derived table
        "with g as (select k, sum(v) as tot from t group by k) "
        "select a.k, b.tot from g a join g b on a.k = b.k order by a.k",
        "select d.s, d.v, row_number() over (partition by d.s order by "
        "d.v, d.k) as rn from (select s, v, k from t where v < 0) d "
        "order by d.s, rn",
    ])


def test_sharded_union_tail_module_matches_jax(pool, jmesh):
    """``parallel.executor.union_tail`` against JAX's
    ``UnionPlan._execute_sharded`` on the same tables:
    UNION ALL under a trailing ORDER BY, and UNION's dedupe junction."""
    t = _ab()
    for sql in ["select k, v from a union all select k, v from b "
                "order by v, k",
                "select k, v from a where v < 50 union "
                "select k, v from b order by k desc, v"]:
        cm = harkdb_tpu.Context(mesh=jmesh)
        for name, src in t.items():
            cm.create_table(name, src)
        b = cm._plan(sql)._execute_sharded(cm.tables, jmesh,
                                           cm._shard_cache)
        n = int(b.n_valid)
        expect = {c: np.asarray(v)[:n] for c, v in b.columns.items()}
        for rank, (cols, caps) in enumerate(pool.run("union_tail", t, sql)):
            assert sorted(cols) == sorted(expect), (rank, sql)
            for c, e in expect.items():
                assert_values(e, cols[c], f"rank {rank} {sql} {c}")
            assert caps[-1][0] == "deliver"


def test_union_all_memory_stays_sharded(pool):
    """The analog of ``test_union_all_memory_stays_sharded``: a UNION ALL
    of two 2^15-row tables under ORDER BY keeps every rank's capacity at
    every stage of the tail within 2/D of the combined rows, and returns
    every row in order on every rank."""
    rng = np.random.default_rng(0)
    n = 1 << 15
    a = pd.DataFrame({"v": rng.integers(0, 1 << 20, n).astype(np.int32)})
    b = pd.DataFrame({"v": rng.integers(0, 1 << 20, n).astype(np.int32)})
    q = "select v from a union all select v from b order by v"
    expect = np.sort(np.concatenate([a.v, b.v]))[:, None]
    for entries in pool.run("run_sql", {"a": a, "b": b}, [q], None, False,
                            True):
        kind, res, _span, _probe, caps = entries[0]
        assert kind == "ok"
        np.testing.assert_array_equal(res, expect)
        stages = [s for s, _c in caps]
        assert stages[-1] == "deliver" and "concat1" in stages, stages
        assert max(c for _s, c in caps) <= 2 * (2 * n // D), caps
