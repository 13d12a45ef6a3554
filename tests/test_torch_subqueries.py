"""harkdb_tpu_torch subqueries vs harkdb_tpu, on the CPU.

The queries of tests/test_subqueries.py and tests/test_exists.py, and the
correlated-aggregate and NULL-in-subquery cases of tests/test_sql_ext.py,
run through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built
from the same seeds as there: scalar subqueries, IN / NOT IN (the OR-tree
below 1024 distinct values, the boolean-LUT gathers above it, with their
guard bits), EXISTS / NOT EXISTS (semi-join and count forms), and the
decorrelated correlated aggregates (LEFT JOINs against grouped derived
tables). Outputs must be identical (integers bit for bit, float32 within
rtol=1e-6, atol=0), errors equal in type and text.
"""

import numpy as np
import pandas as pd
import pytest

from harkdb_tpu_torch.sql.ast_nodes import InSub, SubQuery, walk
from test_torch_derived import (  # noqa: F401  (tpch_pair: a fixture)
    assert_error_same, assert_nothing_held, assert_query_same, make_pair,
    q18_text, tpch_pair,
)


def _qctx():
    """tests/test_subqueries.py's ``qctx`` (rng seed 0)."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({
        "k": rng.integers(0, 6, 300).astype(np.int32),
        "v": rng.integers(-50, 50, 300).astype(np.int32),
    })
    return {"t": t, "hot": pd.DataFrame({"key": np.int32([1, 3, 4])})}


def _cities():
    """tests/test_subqueries.py's string tables (rng seed 0 each)."""
    rng = np.random.default_rng(0)
    s = pd.DataFrame({
        "city": rng.choice(["oslo", "bergen", "alta"], 100),
        "v": rng.integers(0, 100, 100).astype(np.int32),
    })
    rng = np.random.default_rng(0)
    s4 = pd.DataFrame({
        "city": rng.choice(["oslo", "bergen", "alta", "narvik"], 200),
        "v": rng.integers(0, 100, 200).astype(np.int32),
    })
    return {
        "s": s, "s4": s4,
        "names": pd.DataFrame({"n": ["bergen", "alta"]}),
        "coast": pd.DataFrame({"n": ["bergen", "narvik", "x"]}),
        "sv": pd.DataFrame({"city": ["a", "b"], "v": [1, 2]}),
        "nm": pd.DataFrame({"name": ["ann", "bea"], "v": [1, 2]}),
        "seq": pd.DataFrame({"k": np.arange(1000, dtype=np.int32),
                             "v": np.ones(1000, dtype=np.int32)}),
    }


def _ectx():
    """tests/test_exists.py's ``ectx`` (rng seed 0), the LUT guard-bit
    tables and the string-LUT tables (rng seed 0)."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({
        "k": rng.integers(0, 3000, 4000).astype(np.int32),
        "v": rng.integers(-50, 50, 4000).astype(np.int32),
    })
    r = pd.DataFrame({
        "j": rng.integers(0, 3000, 3500).astype(np.int32),
        "w": rng.integers(0, 100, 3500).astype(np.int32),
    })
    rng = np.random.default_rng(0)
    s1 = pd.DataFrame(
        {"s": [f"id{i:05d}" for i in rng.integers(0, 3000, 5000)]})
    s2 = pd.DataFrame(
        {"s": [f"id{i:05d}" for i in rng.integers(0, 2000, 4000)]})
    return {
        "t": t, "r": r, "s1": s1, "s2": s2,
        "big": pd.DataFrame(
            {"j": np.arange(2000, dtype=np.int32) * 2 + 100}),
        "p": pd.DataFrame({"x": np.int32([0, 99, 100, 101, 4097, 4098,
                                          5000, 9999])}),
        # values at the int32 boundary: the LUT index would wrap
        "edge": pd.DataFrame({"e": np.arange(2000, dtype=np.int32)
                              + np.int32(2**31 - 2000)}),
    }


def _corr():
    """tests/test_sql_ext.py's ``tctx``, its ``nctx2`` (f, d) and the
    TestDecorrelate differential tables (rng seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "t": pd.DataFrame({"k": np.int32([1, 1, 2, 2, 3]),
                           "v": np.int32([10, 20, 30, 40, 50])}),
        "r": pd.DataFrame({"k": np.int32([1, 1, 2]),
                           "w": np.int32([5, 15, 100])}),
        "f": pd.DataFrame({"k": np.int32([1, 2, 3]),
                           "v": np.int32([10, 20, 30])}),
        "d": pd.DataFrame({"j": np.int32([1, 2]), "m": np.int32([10, 99])}),
        "tt": pd.DataFrame({"k": rng.integers(0, 20, 200).astype(np.int32),
                            "v": rng.integers(0, 100, 200).astype(np.int32)}),
        "rr": pd.DataFrame({"k": rng.integers(0, 12, 80).astype(np.int32),
                            "w": rng.integers(0, 100, 80).astype(np.int32)}),
    }


SETS = {"qctx": _qctx, "cities": _cities, "ectx": _ectx, "corr": _corr}
_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        _CONTEXTS[name] = make_pair(SETS[name]())
    return _CONTEXTS[name]


_NULL_SUB = "(select d.m from f left join d on f.k = d.j)"

CASES = [
    # tests/test_subqueries.py TestScalarSubquery
    ("qctx", "select k, v from t where v > (select avg(v) from t)"),
    ("qctx", "select v - (select min(v) from t) as adj from t"),
    ("qctx", "select k, sum(v) as s from t group by k "
             "having sum(v) > (select avg(v) from t) order by k"),
    ("cities", "select v from s where city = (select max(n) from names)"),
    ("qctx", "select count(*) as n from t where v > (select avg(v) from t)"),
    ("qctx", "select count(*) as n from t where k in (select key from hot)"),
    # TestInSubquery
    ("qctx", "select k, v from t where k in (select key from hot)"),
    ("qctx", "select k from t where k not in (select key from hot)"),
    ("qctx", "select k from t where k in (select key from hot "
             "where key > 99)"),
    ("qctx", "select k from t where k not in (select key from hot "
             "where key > 99)"),
    ("cities", "select city from s4 where city in (select n from coast)"),
    ("qctx", "select k, count(*) as n from t "
             "where k in (select key from hot where key < 4) "
             "group by k order by k"),
    # TestSubqueryDistributed's query (one device here)
    ("qctx", "select k, sum(v) as s from t where k in (select key from hot) "
             "and v > (select min(v) from t) group by k order by k"),
    # TestSubqueryOrderLimit
    ("qctx", "select v - (select v from t order by v limit 1) as d from t"),
    ("qctx", "select k from t "
             "where k in (select key from hot order by key desc limit 2)"),
    ("qctx", "select count(*) as n from t where k = "
             "(select key from hot order by key limit 1 offset 1)"),
    # TestSubqueryReviewRegressions
    ("cities", "select count(*) as n from seq where k in (select k from seq)"),
    ("qctx", "select k, sum(v - (select min(v) from t)) over "
             "(partition by k) as s from t"),
    ("qctx", "select row_number() over "
             "(order by v + (select min(v) from t)) as rn from t"),
    ("qctx", "select k, rank() over (order by v) in (select key from hot) "
             "as b from t"),
    ("cities", "select count(*) as n from nm "
               "where 'bea' = (select max(name) from nm)"),
    ("cities", "select count(*) as n from nm "
               "where 'zzz' = (select max(name) from nm)"),
    # tests/test_exists.py TestExists
    ("ectx", "select count(*) as n from t where exists "
             "(select 1 from r where r.j = t.k and r.w > 50)"),
    ("ectx", "select count(*) as n from t where not exists "
             "(select 1 from r where r.j = t.k)"),
    ("ectx", "select count(*) as n from t where exists "
             "(select 1 from r where t.k = r.j)"),
    ("ectx", "select k from t where exists (select 1 from r where w >= 0) "
             "limit 3"),
    ("ectx", "select k from t where exists (select 1 from r where w > 1000)"),
    ("ectx", "select count(*) as n from t where v > 0 and exists "
             "(select 1 from r where r.j = t.k)"),
    ("ectx", "select k, v from t where not exists "
             "(select 1 from r where r.j = t.k and r.w > 80) "
             "order by k, v limit 40"),
    ("ectx", "select k from t where exists (select 1 from r limit 0)"),
    ("ectx", "select k from t where exists (select 1 from r where w > 98 "
             "offset 30) limit 4"),
    ("ectx", "select count(*) as n from t group by v > 0 "
             "having exists (select 1 from r where w > 50)"),
    # TestBigInSets
    ("ectx", "select count(*) as n from t where k in (select j from r)"),
    ("ectx", "select count(*) as n from t where k not in (select j from r)"),
    ("ectx", "select x from p where x in (select j from big) order by x"),
    ("ectx", "select x from p where x not in (select j from big) order by x"),
    ("ectx", "select count(*) as n from s1 where s in (select s from s2)"),
    ("ectx", "select count(*) as n from s1 where s not in (select s from s2)"),
    # TestEmptyAggregateSingleton
    ("ectx", "select count(*) as n, sum(v) as s, max(v) as m, avg(v) as a "
             "from t where v > 999"),
    ("ectx", "select count(*) as n, min(v) as m from t"),
    # tests/test_sql_ext.py TestDecorrelate
    ("corr", "select t.k, t.v from t "
             "where t.v > (select avg(r.w) from r where r.k = t.k) "
             "order by t.k, t.v"),
    ("corr", "select t.k, (select count(*) from r where r.k = t.k) as n "
             "from t order by t.k, t.v"),
    ("corr", "select t.k, (select max(r.w) from r where r.k = t.k) as mx "
             "from t order by t.k, t.v"),
    ("corr", "select distinct t.k, (select sum(r.w) from r "
             "where r.k = t.k and r.w < 50) as s from t order by t.k"),
    ("corr", "select tt.k, tt.v from tt "
             "where tt.v > (select avg(rr.w) from rr where rr.k = tt.k) "
             "order by tt.k, tt.v"),
    # TestNullInSubquerySets
    ("corr", f"select v from f where v in {_NULL_SUB}"),
    ("corr", f"select v from f where v not in {_NULL_SUB}"),
    ("corr", "select v from f where v not in "
             "(select d.m from f join d on f.k = d.j)"),
]


@pytest.mark.parametrize("tables,query", CASES)
def test_subquery_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_query_same(j, p, query)


ERRORS = [
    # tests/test_subqueries.py TestSubqueryErrors
    ("qctx", "select k from t where v > (select k, v from t)"),
    ("qctx", "select k from t where v > (select v from t)"),
    ("qctx", "select k from t where v > (select x from nope)"),
    ("qctx", "select k from t where v > "
             "(select key from hot where hot.key = t.k)"),
    ("qctx", "select k from t where v > (select key from hot "
             "where key = v)"),
    ("cities", "select v from sv where v = (select max(city) from sv)"),
    # tests/test_exists.py
    ("ectx", "select k from t where exists "
             "(select 1 from r where r.j = t.k and r.w > t.v)"),
    ("ectx", "select exists (select 1 from r) from t"),
    ("ectx", "select k from t where exists "
             "(select 1 from r where r.j = t.k offset 2)"),
    ("ectx", "select k from t where exists "
             "(select j from r group by j)"),
    ("ectx", "select count(*) as n from t where v in (select e from edge)"),
    # tests/test_sql_ext.py TestDecorrelate / TestNullInSubquerySets
    ("corr", "select t.k from t "
             "where t.v > (select r.w from r where r.k < t.k)"),
    ("corr", "select v from f where v > (select d.m from f f2 "
             "left join d on f2.k = d.j where f2.k = 3)"),
]


@pytest.mark.parametrize("tables,query", ERRORS)
def test_subquery_error_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_error_same(j, p, query)


def _unbound(plan) -> bool:
    """The plan's expressions still hold their subquery nodes: no value
    substituted outlives an execution."""
    return any(isinstance(n, (SubQuery, InSub))
               for e in plan._iter_exprs() for n in walk(e))


def test_table_change_invalidates_subquery():
    """tests/test_subqueries.py test_table_change_invalidates: the answer
    follows a changed table; the cached plan keeps its subquery unbound
    between executions, so no substituted literal survives the change."""
    j, p = make_pair(_qctx())
    q = "select count(*) as n from t where k in (select key from hot)"
    assert_query_same(j, p, q)
    assert p.last_metrics.cached_plan
    assert _unbound(p._plan(q))
    for c in (j, p):
        c.create_table("hot", pd.DataFrame({"key": np.int32([0])}))
    assert_query_same(j, p, q)
    assert _unbound(p._plan(q))


def test_subquery_readback_once_per_plan():
    """Each subquery runs once per execution, a cached plan's too: its
    value is read back once and substituted into that execution only."""
    j, p = make_pair(_qctx())
    q = "select k, v from t where v > (select avg(v) from t)"
    assert_query_same(j, p, q)
    plan = p._plan(q)
    (sub,) = plan._subplans.values()
    calls = []
    orig = sub.execute
    sub.execute = lambda tables: calls.append(1) or orig(tables)
    try:
        p.sql(q)
    finally:
        sub.execute = orig
    assert calls == [1]
    assert p.last_metrics.cached_plan and p.last_metrics.inner_plans_run == 1
    assert _unbound(plan)


@pytest.mark.parametrize("shape", ["q18", "scalar"])
def test_subquery_lives_for_one_execution(tpch_pair, shape):
    """Q18's IN subquery (a grouped HAVING over lineitem) and a scalar
    subquery run on every execution, a repeated text's too, and no cached
    plan keeps a batch, a tensor or a substituted value once its query
    returns; every answer equals the JAX package's."""
    j, p = tpch_pair
    text = {"q18": q18_text,
            "scalar": lambda i: (
                "select count(*) as n from lineitem where l_quantity > "
                f"(select avg(l_quantity) from lineitem where l_partkey = "
                f"{i}) and l_partkey < {i + 20}")}[shape]
    for i in range(13):
        assert_query_same(j, p, text(i))     # sql, then sql_df: one repeat
        assert p.last_metrics.cached_plan
        assert p.last_metrics.inner_plans_run == 1
        assert_nothing_held(p)
        assert _unbound(p._plan(text(i)))
    p.sql(text(0))
    assert p.last_metrics.inner_plans_run == 1
