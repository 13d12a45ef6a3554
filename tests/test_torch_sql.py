"""harkdb_tpu_torch end to end vs harkdb_tpu, on the CPU.

The same SQL runs through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables: the main
query of the port's slice, the single-table corpus of tests/test_sql.py,
the star join and the dense-key GROUP BY (rows and plan fields), TPC-H
Q1, Q3, Q4, Q5, Q13 and Q17's shapes, ``explain`` of a 3-way join, error texts
(compared verbatim), one query of each nested feature (window functions,
set operations, derived tables / CTEs / views, IN / EXISTS / scalar and
correlated subqueries), the two routes that carry the JAX package's tables
over, and the import boundary (no jax, no pandas: also for a numeric CSV,
``debug_checks`` and the CLI). Integer outputs must be
bit-identical; float32 outputs use rtol=1e-6, atol=0. The join / NULL
corpus is tests/test_torch_joins.py; the nested features' corpora are
tests/test_torch_derived.py, test_torch_subqueries.py,
test_torch_union.py, test_torch_windows.py and
test_torch_windows_frames.py.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu_torch.plan.errors import PlanError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_CSV = os.path.join(ROOT, "tests", "data", "data.csv")
MAIN_QUERY = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
              "where v > 0 group by k order by s desc")


def _tables():
    rng = np.random.default_rng(0)
    n = 500
    t = pd.DataFrame({
        "k": rng.integers(0, 10, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int32),
        "w": rng.integers(1, 50, n).astype(np.int32),
    })
    rng = np.random.default_rng(1)
    m = 5000
    big = {"k": rng.integers(0, 1 << 20, m).astype(np.int32),
           "v": rng.integers(-1000, 1000, m).astype(np.int32)}
    dup = {"k": rng.integers(0, 300, m).astype(np.int32),
           "v": rng.integers(-1000, 1000, m).astype(np.int32),
           "f": rng.standard_normal(m).astype(np.float32),
           "name": rng.choice(["ant", "bee", "cat", "dog", "eel"], m)}
    return {"game_1": DATA_CSV, "t": t, "t2": t.assign(k2=t.w % 3),
            "main": big, "dup": dup}


@pytest.fixture(scope="module")
def contexts():
    j = harkdb_tpu.Context()
    p = harkdb_tpu_torch.Context(device="cpu")
    for name, src in _tables().items():
        j.create_table(name, src)
        p.create_table(name, src)
    return j, p


def _assert_same(a: np.ndarray, b: np.ndarray, query: str) -> None:
    assert a.shape == b.shape, (query, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, equal_nan=True,
                                   err_msg=query)
    else:
        np.testing.assert_array_equal(b, a, err_msg=query)
    assert a.dtype == b.dtype, (query, a.dtype, b.dtype)


CORPUS = [
    # the port's main path (bench.py's sql stage), and at 5000 distinct-ish
    # keys with HAVING as in chip_smoke.py's second configuration
    MAIN_QUERY,
    MAIN_QUERY.replace("from t ", "from main "),
    MAIN_QUERY.replace("from t ", "from dup ").replace(
        "group by k", "group by k having count(*) >= 8"),
    # tests/test_sql.py TestReferenceParity
    "select col1, col3 from game_1",
    "select col1, max(col3) from game_1 group by col1",
    "select col3, col3, col1 from game_1 limit 1",
    "select col1, prod(col2), sum(col3), max(col4), min(col5) "
    "from game_1 group by col1",
    # TestWhere
    "select col1, col3 from game_1 where col1 > 0",
    "select v from t where k = 3 and v > 0",
    "select v from t where v % 2 = 0 or not w < 25",
    "select col1 from game_1 where col1 > 100",
    # TestGroupByE2E
    "select k, sum(v), min(v), max(w), count(*) from t group by k",
    "select k, sum(v) from t group by k having sum(v) > 0",
    "select k from t group by k having count(*) > 40",
    "select k, sum(w) from t where v > 0 group by k",
    "select max(v), count(*) from t",
    "select count(*) from t",
    "select k, avg(w) from t group by k",
    "select k, k2, sum(v) from t2 group by k, k2",
    # TestOrderByLimit
    "select v from t order by v",
    "select v from t order by v desc limit 5",
    "select v from t order by w, v limit 20",
    "select col1 from game_1 limit 2",
    # TestExpressions
    "select v + w * 2, v - 1 from t limit 50",
    "select k, sum(v * w) from t group by k",
    "select k, max(v) - min(v) from t group by k",
    # TestDistinctInBetween
    "select distinct k from t",
    "select distinct k, k2 from t2",
    "select distinct k from t order by k desc limit 3",
    "select v from t where k in (2, 5, 7)",
    "select v from t where k not in (0, 1, 2, 3, 4)",
    "select v from t where v between -10 and 10",
    "select v from t where v not between -50 and 50",
    "select v from t where v between 0 and 50 and k in (1, 2)",
    # the rest of the single-table surface the slice runs
    "select k, count(distinct v), median(f), stddev(f), prod(v % 3) "
    "from dup where f > -1 group by k having count(*) > 10 "
    "order by k desc limit 40 offset 3",
    "select k % 7 as g, min(f), max(v) from dup group by k % 7 order by g",
    "select sum(v), max(f), avg(v), count(*) from dup where v > 5000",
    "select name, count(*), max(v) from dup where name >= 'bee' group by name",
    "select name, v from dup where name like '%e%' and v < -990 order by v, name",
    "select upper(name), v / 0, v % 0, round(f * 10) from dup "
    "where k < 20 order by v desc, f limit 30",
    "select distinct name from dup order by name desc",
    "select k, v from dup where 1 = 1 order by v limit 10 offset 5",
    # a join over the corpus tables
    "select t.k, t2.w from t join t2 on t.k = t2.k",
]


@pytest.mark.parametrize("query", CORPUS)
def test_query_matches_jax(contexts, query):
    j, p = contexts
    _assert_same(j.sql(query), p.sql(query), query)
    dj, dp = j.sql_df(query), p.sql_df(query)
    assert list(dj.columns) == list(dp.columns)
    pd.testing.assert_frame_equal(dp, dj, check_dtype=False, rtol=1e-6)


ERRORS = [
    "select col1 from nope",
    "select colX from game_1",
    "select col2 from game_1 group by col1",
    "select distinct k from t order by v",
    "select k, sum(sum(v)) from t group by k",
    "select k + 'x' from t",
    "selec a from t",
    "select t.k from t join t on t.k = t.k",
    "select t.k from t join t2 on t.k = t.w",
    "select t.k from t join dup on t.k = dup.name",
    "select t.k from t left join t2 on t.k = t2.k and t.v < t2.w",
]


@pytest.mark.parametrize("query", ERRORS)
def test_error_text_matches_jax(contexts, query):
    j, p = contexts
    with pytest.raises(Exception) as ej:
        j.sql(query)
    with pytest.raises(Exception) as ep:
        p.sql(query)
    assert type(ep.value).__name__ == type(ej.value).__name__
    assert str(ep.value) == str(ej.value)


UNPORTED = [
    ("select k, rank() over (order by v) from t", "Window functions"),
    ("select k from t union select k from t2", "UNION/INTERSECT/EXCEPT"),
    ("with a as (select k from t) select k from a",
     "Derived tables, CTEs and views"),
    ("select d.k from (select k from t) d",
     "Derived tables, CTEs and views"),
    ("select v from t where k in (select k from t2)",
     "IN/EXISTS/scalar subqueries"),
    ("select v from t where exists (select k2 from t2 where t2.k = t.k)",
     "IN/EXISTS/scalar subqueries"),
    ("select v from t where v > (select avg(v) from t2)",
     "IN/EXISTS/scalar subqueries"),
    ("select v from t where v > (select avg(w) from t2 where t2.k = t.k)",
     "IN/EXISTS/scalar subqueries"),
    ("select t.k from t join (select k from t2) d on t.k = d.k",
     "Derived tables, CTEs and views"),
]


@pytest.mark.parametrize("query,feature", UNPORTED)
def test_unported_feature_raises(contexts, query, feature):
    """Each of these once raised a PlanError naming ``feature``; the port
    now runs it, and its output equals the JAX package's."""
    j, p = contexts
    _assert_same(j.sql(query), p.sql(query), query)
    pd.testing.assert_frame_equal(p.sql_df(query), j.sql_df(query),
                                  check_dtype=False, rtol=1e-6)


def test_view_query_raises_but_create_works(contexts):
    """Create a view, query it (equal to the JAX package), drop it; then
    the query fails with the JAX package's error."""
    j, p = contexts
    q = "select k, count(*) as n from vw group by k order by k"
    for c in (j, p):
        c.create_view("vw", "select k, v from t where v > 0")
    try:
        _assert_same(j.sql(q), p.sql(q), q)
    finally:
        for c in (j, p):
            c.drop_view("vw")
    with pytest.raises(Exception) as ej:
        j.sql(q)
    with pytest.raises(PlanError) as ep:
        p.sql(q)
    assert str(ep.value) == str(ej.value) == "vw is not in tables"


def test_explain_and_plan_cache(contexts):
    j, p = contexts
    q = "select col1, max(col3) from game_1 group by col1 order by col1"
    assert p.explain(q) == j.explain(q)
    assert p._plan(q) is p._plan(q)
    assert p.explain(MAIN_QUERY) == j.explain(MAIN_QUERY)


def test_join_total_overflow_guard():
    """A 65536² CROSS JOIN's int32 pair total wraps to exactly 0: both
    packages raise the same PlanError before materializing anything."""
    j = harkdb_tpu.Context()
    p = harkdb_tpu_torch.Context(device="cpu")
    n = 65536
    for c in (j, p):
        c.create_table("a", {"x": np.zeros(n, np.int32)})
        c.create_table("b", {"y": np.zeros(n, np.int32)})
    q = "select count(*) from a cross join b"
    with pytest.raises(Exception) as ej:
        j.sql(q)
    with pytest.raises(PlanError) as ep:
        p.sql(q)
    assert str(ep.value) == str(ej.value)
    assert "pairs" in str(ep.value)


# -- the star join, the dense-key GROUP BY and TPC-H Q3 ------------------------

STAR_QUERY = ("select g, sum(v) as s, count(*) as c from facts join dims "
              "on facts.k = dims.j where v > 0 group by g order by g")
PLAN_FIELDS = ("fast_agg", "fast_candidate", "last_fast_span", "_probed_fast")


def _pair(tables):
    j = harkdb_tpu.Context()
    p = harkdb_tpu_torch.Context(device="cpu")
    for name, src in tables.items():
        j.create_table(name, src)
        p.create_table(name, src)
    return j, p


def _assert_plan_parity(j, p, q):
    """Rows, then the dense-path plan fields, then a second run that must
    reuse the probe cached on the plan."""
    _assert_same(j.sql(q), p.sql(q), q)
    pj, pp = j._plan(q), p._plan(q)
    for f in PLAN_FIELDS:
        assert getattr(pp, f) == getattr(pj, f), (f, q)
    probed = pp._probed_fast
    _assert_same(j.sql(q), p.sql(q), q)
    assert pp._probed_fast is probed
    pd.testing.assert_frame_equal(p.sql_df(q), j.sql_df(q),
                                  check_dtype=False, rtol=1e-6)
    return pp


def test_star_join_small():
    """The chip_smoke star join at 6,000 facts: a permutation dims table
    (every fact key matches once), the dense GROUP BY over span 64."""
    rng = np.random.default_rng(0)
    n, nk = 6000, 1024
    facts = {"k": rng.integers(0, nk, n).astype(np.int32),
             "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    dims = {"j": rng.permutation(nk).astype(np.int32),
            "g": rng.integers(0, 64, nk).astype(np.int32)}
    j, p = _pair({"facts": facts, "dims": dims})
    plan = _assert_plan_parity(j, p, STAR_QUERY)
    assert plan.fast_agg is None and plan.fast_candidate == "dims.g"
    assert plan.last_fast_span == 1024       # span 64, padded to KEY_TILE


def _fast_tables():
    """tests/test_kernels.py TestPlannerFastPath's tables (rng seed 0)."""
    rng = np.random.default_rng(0)
    n = 4000
    t = pd.DataFrame({"k": rng.integers(0, 64, n).astype(np.int32),
                      "v": rng.integers(-1000, 1000, n).astype(np.int32)})
    t2 = pd.DataFrame({"k": rng.integers(0, 32, 2000).astype(np.int32),
                       "v": rng.integers(0, 100, 2000).astype(np.int32)})
    n = 3000
    facts = pd.DataFrame({"k": rng.integers(0, 40, n).astype(np.int32),
                          "v": rng.integers(-50, 50, n).astype(np.int32)})
    dims = pd.DataFrame({"j": np.arange(40, dtype=np.int32),
                         "m": rng.integers(1, 5, 40).astype(np.int32)})
    k = np.concatenate([rng.integers(0, 30, 2000),
                        np.array([10**8])]).astype(np.int32)
    narrow = pd.DataFrame({"k": k, "v": rng.integers(0, 9, k.size).astype(
        np.int32)})
    return {
        "t": t, "t2": t2, "facts": facts, "dims": dims, "narrow": narrow,
        "seq": pd.DataFrame({"k": np.arange(10, dtype=np.int32),
                             "v": np.arange(10, dtype=np.int32)}),
        "wide": pd.DataFrame({"k": np.int32([0, 10**8]),
                              "v": np.int32([1, 2])}),
        "one": pd.DataFrame({"k": np.int32([5]), "v": np.int32([1])}),
        "miss": pd.DataFrame({"j": np.int32([9]), "m": np.int32([1])}),
    }


FAST_PATH = [
    # (query, dense path proven at plan time, dense path taken)
    ("select k, sum(v), count(*) from t group by k", True, True),
    ("select k, avg(v) from t2 where v > 10 group by k "
     "having count(*) > 20 order by k desc", True, True),
    ("select k, max(v) from seq group by k", False, False),
    ("select k, sum(v) from wide group by k", False, False),
    ("select k, sum(v), count(*) from facts join dims on facts.k = dims.j "
     "where v > 0 group by k order by k", False, True),
    ("select k, sum(v) from narrow where k < 1000 group by k", False, True),
    ("select k, sum(v) from one join miss on one.k = miss.j group by k",
     False, False),
]


@pytest.fixture(scope="module")
def fast_contexts():
    return _pair(_fast_tables())


@pytest.mark.parametrize("query,proven,taken", FAST_PATH)
def test_dense_path_plan_matches_jax(fast_contexts, query, proven, taken):
    j, p = fast_contexts
    plan = _assert_plan_parity(j, p, query)
    assert (plan.fast_agg is not None) == proven
    assert (plan.last_fast_span is not None) == taken


def _tpch_tables():
    """tests/test_tpch_mini.py's tables (rng seed 42)."""
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


Q3_QUERY = (
    "select orders.orderkey, sum(lineitem.price * lineitem.qty) as rev "
    "from customer join orders on customer.custkey = orders.custkey "
    "join lineitem on orders.orderkey = lineitem.orderkey "
    "where customer.nation < 10 and orders.odate < 180 "
    "group by orders.orderkey order by rev desc, orders.orderkey "
    "limit 10"
)


def test_q3_shipping_priority_and_explain():
    j, p = _pair(_tpch_tables())
    _assert_plan_parity(j, p, Q3_QUERY)
    assert p.explain(Q3_QUERY) == j.explain(Q3_QUERY)
    assert "SortJoin(inner) orders.orderkey = lineitem.orderkey " \
           "(+ lineitem)" in p.explain(Q3_QUERY)
    q = ("select customer.nation, count(*) as n from customer "
         "left join orders on customer.custkey = orders.custkey "
         "full outer join lineitem on orders.orderkey = lineitem.orderkey "
         "where lineitem.qty > 10 group by customer.nation")
    assert p.explain(q) == j.explain(q)


TPCH_NESTED = {
    # tests/test_tpch_mini.py: EXISTS semi-join + grouped count
    "q4": "select prio, count(*) as n from orders "
          "where exists (select 1 from lineitem "
          "where lineitem.orderkey = orders.orderkey and lineitem.qty > 40) "
          "group by prio order by prio",
    # a CTE over a join, grouped again with HAVING
    "q5": "with rev as (select orders.custkey as ck, "
          "sum(lineitem.price * lineitem.qty) as r from orders "
          "join lineitem on orders.orderkey = lineitem.orderkey "
          "group by orders.custkey) "
          "select customer.nation, sum(rev.r) as vol from customer "
          "join rev on customer.custkey = rev.ck "
          "group by customer.nation having sum(rev.r) > 0 "
          "order by vol desc, customer.nation limit 8",
    # a grouped query over a grouped derived table over a LEFT JOIN
    "q13": "select cnt, count(*) as custs from "
           "(select customer.custkey as k, count(orders.orderkey) as cnt "
           "from customer left join orders "
           "on customer.custkey = orders.custkey "
           "group by customer.custkey) d "
           "group by cnt order by custs desc, cnt limit 10",
    # a correlated scalar subquery, decorrelated into a grouped LEFT JOIN
    "q17": "select sum(price) as total from lineitem l "
           "where l.qty < (select avg(l2.qty) from lineitem l2 "
           "where l2.partkey = l.partkey)",
}


@pytest.fixture(scope="module")
def tpch_contexts():
    return _pair(_tpch_tables())


Q1_QUERY = (
    "select discount, sum(qty) as sq, sum(price * qty) as sp, "
    "avg(price) as ap, count(*) as n from lineitem "
    "where ship <= 300 group by discount order by discount"
)


def test_q1_pricing_summary(tpch_contexts):
    """tests/test_tpch_mini.py Q1: a GROUP BY over ten discount keys with
    a sum of a product and an AVG; rows, plan fields and explain."""
    j, p = tpch_contexts
    _assert_plan_parity(j, p, Q1_QUERY)
    assert p.explain(Q1_QUERY) == j.explain(Q1_QUERY)
    assert p.sql(Q1_QUERY)[:, 0].tolist() == list(range(10))


def test_group_by_sums_scan_one_column_at_a_time(monkeypatch):
    """Q1's three int sums are three 1-D cumsums, never one cumsum along dim
    0 of a 2-D stack (torch's CUDA kernel scans such a stack's columns
    serially: 644 ms for Q1 at SF 1 on an H100)."""
    import torch

    dims = []
    real = torch.cumsum

    def cumsum(x, *args, **kw):
        dims.append(x.dim())
        return real(x, *args, **kw)

    monkeypatch.setattr(torch, "cumsum", cumsum)
    p = harkdb_tpu_torch.Context(device="cpu")
    for name, src in _tpch_tables().items():
        p.create_table(name, src)
    p.sql(Q1_QUERY)
    assert dims and set(dims) == {1}


@pytest.mark.parametrize("name", sorted(TPCH_NESTED))
def test_tpch_nested_shapes(tpch_contexts, name):
    j, p = tpch_contexts
    q = TPCH_NESTED[name]
    _assert_plan_parity(j, p, q)
    assert p.explain(q) == j.explain(q)


def test_load_jax_save_directory(tmp_path):
    tables = _tables()
    j = harkdb_tpu.Context()
    for name in ("t", "dup"):
        j.create_table(name, tables[name])
    j.save(str(tmp_path))
    p = harkdb_tpu_torch.Context(device="cpu")
    p.load(str(tmp_path))
    assert sorted(p.tables) == ["dup", "t"]
    for q in (MAIN_QUERY, "select name, sum(v) from dup group by name"):
        _assert_same(j.sql(q), p.sql(q), q)
    pd.testing.assert_frame_equal(p.sql_df("select name, v from dup"),
                                  j.sql_df("select name, v from dup"))


def test_tables_from_reference():
    tables = _tables()
    j = harkdb_tpu.Context()
    for name in ("main", "dup"):
        j.create_table(name, tables[name])
    ported = harkdb_tpu_torch.tables_from_reference(j.tables, device="cpu")
    p = harkdb_tpu_torch.Context(device="cpu")
    p.tables.update(ported)
    assert ported["dup"].dicts["name"].tolist() == j.tables["dup"].dicts[
        "name"].tolist()
    for q in (MAIN_QUERY.replace("from t ", "from main "),
              "select name, max(f) from dup where name != 'cat' group by name"):
        _assert_same(j.sql(q), p.sql(q), q)


def test_save_load_round_trip(tmp_path, contexts):
    _j, p = contexts
    p.save(str(tmp_path))
    q = p.__class__(device="cpu")
    q.load(str(tmp_path))
    for query in (MAIN_QUERY, "select name, count(*) from dup group by name"):
        np.testing.assert_array_equal(q.sql(query), p.sql(query))


def test_import_leaves_jax_out(tmp_path):
    """The package, its distributed layer (``harkdb_tpu_torch.parallel``
    and every module in it), a numeric CSV through the native loader, a
    query under ``debug_checks`` and the CLI's ``--explain`` import neither
    jax, the JAX package nor pandas."""
    csv = tmp_path / "n.csv"
    csv.write_text("k,v\n1,3\n2,4\n2,5\n")
    code = ("import pkgutil, importlib, sys, harkdb_tpu_torch\n"
            "import harkdb_tpu_torch.parallel as par\n"
            "for m in pkgutil.iter_modules(par.__path__):\n"
            "    importlib.import_module('harkdb_tpu_torch.parallel.' + "
            "m.name)\n"
            "assert len([m for m in sys.modules if m.startswith("
            "'harkdb_tpu_torch.parallel.')]) >= 7\n"
            "from harkdb_tpu_torch.__main__ import main\n"
            "c = harkdb_tpu_torch.Context(device='cpu')\n"
            "c.create_table('t', {'k': [1, 2, 2], 'v': [3, 4, 5]})\n"
            "assert c.sql('select k, sum(v) from t group by k').tolist() "
            "== [[1, 3], [2, 9]]\n"
            "d = harkdb_tpu_torch.Context(harkdb_tpu_torch.EngineConfig("
            "debug_checks=True), device='cpu')\n"
            f"d.create_table('n', {str(csv)!r})\n"
            "assert d.sql('select k, sum(v) from n where v > 3 group by k')"
            ".tolist() == [[2, 9]]\n"
            f"assert main(['--cpu', '--table', 'n={csv}', '--explain', "
            "'select k from n']) == 0\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'harkdb_tpu.')) or m == 'harkdb_tpu']\n"
            "assert not bad, bad\n"
            "assert 'pandas' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Scan n as n" in out.stdout


def test_context_device_and_mesh():
    """A window query on a mesh of 2 gloo ranks equals JAX's 2-device mesh
    on every rank; a mesh needs an initialised process group (the message
    names torchrun); the device is the Context's."""
    import torch

    from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
    from harkdb_tpu_torch.parallel import make_engine_mesh
    from torch_mesh_pool import MeshPool, assert_same, jax_sql

    tables = {"t": {"k": np.arange(9, dtype=np.int32) % 4}}
    queries = ["select k, rank() over (order by k) from t"]
    pool = MeshPool(2)
    try:
        got = pool.run("run_sql", tables, queries)
    finally:
        pool.close()
    assert_same(jax_sql(jax_mesh(2), tables, queries), got, queries)
    with pytest.raises(RuntimeError, match="torchrun"):
        harkdb_tpu_torch.Context(device="cpu", mesh=make_engine_mesh())
    c = harkdb_tpu_torch.Context(device="cpu")
    c.create_table("t", {"k": np.arange(4, dtype=np.int32)})
    assert c.tables["t"].columns["k"].device.type == "cpu"
    assert c.sql_batch("select k from t")[0].n_valid.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            harkdb_tpu_torch.Context()
