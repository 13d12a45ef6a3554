"""harkdb_tpu_torch's nested queries on a mesh vs harkdb_tpu's, on the CPU:
three-valued logic over outer joins, EXISTS, subqueries, TPC-H shapes
with a CTE and a derived table, and a two-join chain.

The mesh cases of tests/test_nulls3vl.py (``test_3vl_and_null_aggs_on_mesh``,
``test_dist_null_key_tie_order``), tests/test_tpch_mini.py
(``test_distributed_parity_subset``, and Q5 with its CTE and Q13 with its
derived table on the mesh), tests/test_exists.py (``test_distributed_parity``
and ``test_distributed``), tests/test_subqueries.py
(``TestSubqueryDistributed.test_matches_single``) and tests/test_sql.py
(``test_two_joins_distributed_matches``), with the same tables from the
same seeds. The port runs in a pool of 4 gloo ranks (``torch_mesh_pool``);
every rank's ``sql_df`` frame must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s: integers bit for bit,
NULLs in the same places, the ``avg`` columns within rtol 1e-6.
"""

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


def check(pool, jmesh, tables, queries, frames=True):
    expect = jax_sql(jmesh, tables, queries, frames=frames)
    assert all(e[0] == "ok" for e in expect), expect
    assert_same(expect, pool.run("run_sql", tables, queries, None, frames),
                queries)


def test_3vl_and_null_aggs_on_mesh(pool, jmesh):
    rng = np.random.default_rng(0)
    nl, nr = 500, 200
    ldf = pd.DataFrame({"k": rng.integers(0, 80, nl).astype(np.int32),
                        "x": rng.integers(-50, 50, nl).astype(np.int32)})
    rdf = pd.DataFrame({"j": rng.integers(0, 50, nr).astype(np.int32),
                        "m": rng.integers(-100, 100, nr).astype(np.int32)})
    check(pool, jmesh, {"l": ldf, "r": rdf}, [
        "select l.k, l.x, r.m from l left join r on l.k = r.j "
        "where not (r.m > 0) order by l.k, l.x, r.m",
        "select l.k, sum(r.m) as s, avg(r.m) as a from l "
        "left join r on l.k = r.j group by l.k "
        "having avg(r.m) > -50 order by l.k",
        "select l.k, count(distinct r.m) as cd from l "
        "left join r on l.k = r.j group by l.k order by l.k",
        "select sum(r.m) as s from l left join r on l.k = r.j "
        "where r.m > 999",
    ])


def test_dist_null_key_tie_order(pool, jmesh):
    """A NULL key's 0-fill tying a real key 0 keeps the single-device row
    order on the mesh."""
    check(pool, jmesh, {
        "a": pd.DataFrame({"k": np.int32([1, 2])}),
        "r": pd.DataFrame({"k": np.int32([2]), "j": np.int32([0])}),
        "s": pd.DataFrame({"j": np.int32([0]), "w": np.int32([100])}),
    }, ["select a.k, r.j, s.w from a left join r on a.k = r.k "
        "left join s on r.j = s.j"])


def _tpch():
    """tests/test_tpch_mini.py's ``db`` tables."""
    rng = np.random.default_rng(42)
    n_li, n_ord, n_cust = 3000, 800, 120
    orders = pd.DataFrame({
        "orderkey": np.arange(n_ord, dtype=np.int32),
        "custkey": rng.integers(0, n_cust + 20, n_ord).astype(np.int32),
        "odate": rng.integers(0, 365, n_ord).astype(np.int32),
        "prio": rng.integers(1, 6, n_ord).astype(np.int32),
    })
    lineitem = pd.DataFrame({
        "orderkey": rng.integers(0, n_ord, n_li).astype(np.int32),
        "partkey": rng.integers(0, 200, n_li).astype(np.int32),
        "qty": rng.integers(1, 50, n_li).astype(np.int32),
        "price": rng.integers(100, 10000, n_li).astype(np.int32),
        "discount": rng.integers(0, 10, n_li).astype(np.int32),
        "ship": rng.integers(0, 365, n_li).astype(np.int32),
    })
    customer = pd.DataFrame({
        "custkey": np.arange(n_cust, dtype=np.int32),
        "nation": rng.integers(0, 25, n_cust).astype(np.int32),
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer}


def test_tpch_distributed_parity_subset(pool, jmesh):
    """``test_distributed_parity_subset`` (Q1 and Q4 shapes), Q5 (a CTE)
    and Q13 (a derived table)."""
    check(pool, jmesh, _tpch(), [
        "select discount, sum(qty) as sq, count(*) as n from lineitem "
        "where ship <= 300 group by discount order by discount",
        "select prio, count(*) as n from orders "
        "where exists (select 1 from lineitem "
        "where lineitem.orderkey = orders.orderkey and lineitem.qty > 40) "
        "group by prio order by prio",
        "with rev as (select orders.custkey as ck, "
        "sum(lineitem.price * lineitem.qty) as r from orders "
        "join lineitem on orders.orderkey = lineitem.orderkey "
        "group by orders.custkey) "
        "select customer.nation, sum(rev.r) as vol from customer "
        "join rev on customer.custkey = rev.ck "
        "group by customer.nation having sum(rev.r) > 0 "
        "order by vol desc, customer.nation limit 8",
        "select cnt, count(*) as custs from "
        "(select customer.custkey as k, count(orders.orderkey) as cnt "
        "from customer left join orders "
        "on customer.custkey = orders.custkey group by customer.custkey) d "
        "group by cnt order by custs desc, cnt limit 10",
    ])


def _exists_tables():
    """tests/test_exists.py's ``ectx`` tables."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"k": rng.integers(0, 3000, 4000).astype(np.int32),
                      "v": rng.integers(-50, 50, 4000).astype(np.int32)})
    r = pd.DataFrame({"j": rng.integers(0, 3000, 3500).astype(np.int32),
                      "w": rng.integers(0, 100, 3500).astype(np.int32)})
    return {"t": t, "r": r}


def test_exists_distributed_parity(pool, jmesh):
    """``TestExists.test_distributed_parity`` and the empty-input
    aggregates of ``test_distributed``."""
    check(pool, jmesh, _exists_tables(), [
        "select count(*) as n from t where exists "
        "(select 1 from r where r.j = t.k)",
        "select k, v from t where not exists "
        "(select 1 from r where r.j = t.k and r.w > 80) "
        "order by k, v limit 40",
        "select count(*) as n, sum(v) as s, min(v) as m "
        "from t where v > 999",
    ])


def test_subqueries_distributed_matches_jax(pool, jmesh):
    rng = np.random.default_rng(0)
    df = pd.DataFrame({"k": rng.integers(0, 6, 300).astype(np.int32),
                       "v": rng.integers(-50, 50, 300).astype(np.int32)})
    hot = pd.DataFrame({"key": np.array([1, 3], np.int32)})
    check(pool, jmesh, {"t": df, "hot": hot}, [
        "select k, sum(v) as s from t "
        "where k in (select key from hot) "
        "and v > (select min(v) from t) group by k order by k"])


def test_two_joins_distributed_matches(pool, jmesh):
    rng = np.random.default_rng(0)
    facts = pd.DataFrame({"k1": rng.integers(0, 6, 300).astype(np.int32),
                          "k2": rng.integers(0, 4, 300).astype(np.int32),
                          "v": rng.integers(-50, 50, 300).astype(np.int32)})
    d1 = pd.DataFrame({"a": np.arange(6, dtype=np.int32),
                       "w1": rng.integers(1, 9, 6).astype(np.int32)})
    d2 = pd.DataFrame({"b": np.arange(4, dtype=np.int32),
                       "w2": rng.integers(1, 9, 4).astype(np.int32)})
    check(pool, jmesh, {"f": facts, "d1": d1, "d2": d2}, [
        "select k1, k2, v, w1, w2 from f "
        "join d1 on f.k1 = d1.a join d2 on f.k2 = d2.b "
        "order by k1, k2, v, w1, w2"], frames=False)
