"""harkdb_tpu_torch's distributed tail vs harkdb_tpu's, on the CPU.

Every case of tests/test_dist_tail.py: the range-partitioned ORDER BY,
the sharded OFFSET / LIMIT, the per-rank projection, DISTINCT, the join
tails, the ``dist_tail=False`` gather path, and the memory property (after
the distributed sort every rank holds O(rows / D); the grouped tail's
``last_tail_capacities`` stay O(groups / D)). The port runs in a pool of 4
gloo ranks (``torch_mesh_pool``); every rank's whole result must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s (integers bit for bit,
floats within rtol 1e-6).
"""

import jax
import numpy as np
import pandas as pd
import pytest

from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from torch_mesh_pool import assert_same, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def _pair_tables():
    rng = np.random.default_rng(0)
    n = 700
    t = pd.DataFrame({
        "k": rng.integers(0, 12, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int32),
        "w": rng.integers(1, 50, n).astype(np.int32),
    })
    r = pd.DataFrame({
        "j": np.arange(12, dtype=np.int32),
        "m": rng.integers(1, 9, 12).astype(np.int32),
    })
    return {"t": t, "r": r}


def check(pool, jmesh, tables, queries, cfg=None, capacities=False):
    expect = jax_sql(jmesh, tables, queries, cfg)
    got = pool.run("run_sql", tables, queries, cfg, False, capacities)
    assert_same(expect, got, queries)
    return got


PAIR_QUERIES = {
    # TestOrderByE2E
    "single_key": "select k, v from t order by v",
    "desc": "select k, v from t order by v desc",
    "multi_key_mixed": "select k, v, w from t order by k desc, w, v",
    "expression_key": "select k, v from t order by v * v - k desc",
    # heavy ties: the tie chain (pre-shuffle position) must match
    "ties_stable": "select k, v, w from t order by k",
    "where_then_order": "select v, w from t where v > 0 "
                        "order by w desc, v",
    # TestOffsetLimit
    "limit": "select v from t order by v limit 17",
    "offset": "select v from t order by v desc offset 100",
    "offset_limit": "select k, v from t order by v, k limit 50 offset 333",
    "limit_no_order": "select k, v from t limit 23",
    "offset_past_end": "select v from t order by v offset 10000",
    # TestJoinTail
    "join_order_parity_no_orderby": "select k, v, m from t join r "
                                    "on t.k = r.j",
    "join_with_orderby": "select k, v, m from t join r on t.k = r.j "
                         "order by m desc, v limit 40",
    "left_join_order": "select k, v, m from t left join r on t.k = r.j "
                       "order by v limit 60",
    # TestMemoryProperty (bit-equality cases)
    "grouped_avg_having_on_avg": "select k, avg(v) as a from t group by k "
                                 "having avg(v) > -5 order by a desc, k "
                                 "limit 7",
    "grouped_distinct_tail": "select distinct w, count(*) from t "
                             "group by w order by w",
    # TestDistinctDistributed
    "distinct": "select distinct k from t",
    "distinct_multicol": "select distinct k, w from t",
    "distinct_orderby_limit": "select distinct k, w from t "
                              "order by w desc, k limit 9",
    "distinct_expression": "select distinct v % 7 from t where v > 0",
    "distinct_after_join": "select distinct k, m from t join r "
                           "on t.k = r.j order by m",
}


@pytest.mark.parametrize("name", list(PAIR_QUERIES))
def test_tail_query(pool, jmesh, name):
    check(pool, jmesh, _pair_tables(), [PAIR_QUERIES[name]])


def test_float_order_key(pool, jmesh):
    rng = np.random.default_rng(0)
    n = 500
    ft = pd.DataFrame({
        "f": (rng.standard_normal(n) * 100).astype(np.float32),
        "i": np.arange(n, dtype=np.int32),
    })
    check(pool, jmesh, {"ft": ft}, ["select i, f from ft order by f",
                                    "select i, f from ft order by f desc"])


def test_local_capacity_stays_sharded(pool):
    """After the distributed ORDER BY each rank's block capacity is
    O(global / D), and the blocks in rank order are the sorted column."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    v = rng.integers(0, 1 << 30, n).astype(np.int32)
    got = pool.run("orderby_head", v)
    for _block, cap in got:
        assert cap <= (n // D) * 4, (cap, n // D)
    np.testing.assert_array_equal(np.concatenate([b for b, _c in got]),
                                  np.sort(v))


def test_grouped_tail_stays_sharded(pool, jmesh):
    """A high-cardinality grouped query keeps every rank's capacity about
    1/D of the group count through the whole tail (HAVING / ORDER BY /
    LIMIT), and is bit-equal to JAX."""
    rng = np.random.default_rng(0)
    n = 1 << 17
    n_groups = 1 << 16
    t = pd.DataFrame({
        "k": rng.permutation(
            np.tile(np.arange(n_groups, dtype=np.int32), n // n_groups)),
        "v": rng.integers(-50, 50, n).astype(np.int32),
    })
    q = ("select k, sum(v) as s, count(*) as c from t group by k "
         "having count(*) >= 1 order by k limit 200000")
    got = check(pool, jmesh, {"t": t}, [q], capacities=True)
    for entries in got:
        for stage, cap in entries[0][4]:
            assert cap <= (n_groups // D) * 4, (stage, cap, n_groups // D)


def test_dist_head_window(pool):
    n = 4096
    v = np.arange(n, dtype=np.int32)
    got = pool.run("orderby_head", v, 1000, 500)
    np.testing.assert_array_equal(np.concatenate([b for b, _c in got]),
                                  v[1000:1500])


def test_dist_tail_off_matches(pool, jmesh):
    """The gather path: the whole result on every rank, then run_tail."""
    rng = np.random.default_rng(0)
    n = 400
    t = pd.DataFrame({"k": rng.integers(0, 9, n).astype(np.int32),
                      "v": rng.integers(-50, 50, n).astype(np.int32)})
    check(pool, jmesh, {"t": t}, [
        "select k, v from t order by v desc limit 19",
        "select k, sum(v), count(*) from t group by k having sum(v) > 0",
        "select k, v from t join t as u on t.k = u.k where t.v > 40 "
        "order by t.v, u.v limit 30",
    ], cfg={"dist_tail": False})


def test_dist_orderby_int64_keys_route_monotone(pool, jmesh):
    """The range partition's routing view must not truncate int64 keys to
    int32 (wrapping would make rank ranges overlap)."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"v": rng.integers(-(2**40), 2**40, 2048).astype(
        np.int64)})
    q = ["select v from t order by v limit 50"]
    with jax.enable_x64(True):
        cfg = {"int_dtype": "int64"}
        expect = jax_sql(jmesh, {"t": t}, q, cfg)
    assert_same(expect, pool.run("run_sql", {"t": t}, q, cfg), q)
