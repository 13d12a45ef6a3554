"""harkdb_tpu_torch window functions vs harkdb_tpu, on the CPU: ranking,
running and whole-partition aggregates, positional functions, windows over
grouped output, and the window errors.

The queries of tests/test_windows.py (TestRankingFuncs, TestRunningAggregates,
TestWindowInteractions, TestWindowErrors, TestWindowsOverGroupedOutput,
TestPositionalWindowFuncs and the distributed classes' queries, one device
here) run through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built from
the same seeds as there. Outputs must be identical (integers bit for bit,
float32 within rtol=1e-6, atol=0), errors equal in type and text. The JAX
package's known fault is held, not fixed: window aggregates ignore the NULL
validity of their argument. ROWS frames and sort-order tracking are
tests/test_torch_windows_frames.py.
"""

import numpy as np
import pandas as pd
import pytest

from test_torch_derived import assert_error_same, assert_query_same, make_pair


def emp(n, seed=0):
    """tests/test_windows.py's ``wctx`` table (``n`` = 200 there; the
    distributed tests draw 300 rows without the float column)."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "dept": rng.choice(["eng", "ops", "hr", "sales"], n),
        "pay": rng.integers(50, 150, n).astype(np.int32),
        "yr": rng.integers(2018, 2023, n).astype(np.int32),
    })
    if n == 200:
        df["f"] = rng.standard_normal(n).astype(np.float32)
    return df


def _wctx():
    rng = np.random.default_rng(0)
    left = pd.DataFrame({"k": rng.integers(0, 4, 60).astype(np.int32),
                         "v": rng.integers(0, 100, 60).astype(np.int32)})
    rng = np.random.default_rng(0)
    grp = pd.DataFrame({
        "dept": rng.choice(["a", "b", "c", "d"], 600),
        "reg": rng.choice(["x", "y", "z"], 600),
        "pay": rng.integers(1, 100, 600).astype(np.int32),
    })
    rng = np.random.default_rng(0)
    s = pd.DataFrame({
        "k": rng.choice(["a", "b", "c"], 200),
        "t": np.arange(200, dtype=np.int32),
        "v": rng.integers(0, 100, 200).astype(np.int32),
    })
    return {
        "emp": emp(200), "emp3": emp(300), "l": left,
        "d": pd.DataFrame({"j": np.arange(4, dtype=np.int32),
                           "w": np.int32([10, 20, 30, 40])}),
        "g": grp, "s": s,
        # a LEFT JOIN whose NULL rows feed a window aggregate
        "nf": pd.DataFrame({"k": np.int32([1, 2, 3, 4, 5])}),
        "nd": pd.DataFrame({"j": np.int32([1, 3]), "m": np.int32([7, 9])}),
    }


_CONTEXTS = {}


def _contexts():
    if not _CONTEXTS:
        _CONTEXTS["w"] = make_pair(_wctx())
    return _CONTEXTS["w"]


CASES = [
    # TestRankingFuncs
    "select dept, pay, row_number() over "
    "(partition by dept order by pay desc) as rn from emp",
    "select dept, pay, rank() over (partition by dept order by pay) as rk "
    "from emp order by dept, pay",
    "select yr, dense_rank() over (order by yr) as dr from emp order by yr",
    "select rank() over (partition by dept) as rk from emp",
    # TestRunningAggregates
    "select dept, pay, sum(pay) over (partition by dept order by pay) as rs "
    "from emp order by dept, pay",
    "select dept, pay, count(*) over (partition by dept order by pay) as "
    "cnt, min(pay) over (partition by dept order by pay) as mn, "
    "max(pay) over (partition by dept order by pay) as mx "
    "from emp order by dept, pay",
    "select dept, sum(pay) over (partition by dept) as tot, "
    "avg(pay) over (partition by dept) as ap, "
    "count(*) over (partition by dept) as n from emp",
    "select yr, f, sum(f) over (partition by yr order by f) as rs "
    "from emp order by yr, f",
    "select sum(pay) over () as tot from emp",
    "select dept, pay, sum(pay) over (partition by dept order by pay desc) "
    "as rs from emp order by dept, pay desc",
    "select dept, prod(pay % 3 + 1) over (partition by dept order by yr) "
    "as pr, max(f) over (partition by yr order by pay desc) as mf, "
    "min(f) over (partition by dept) as lf from emp",
    # TestWindowInteractions
    "select dept, count(*) over (partition by dept) as n from emp "
    "where pay > 100",
    "select dept, pay, row_number() over "
    "(partition by dept order by pay desc) as rn from emp "
    "order by dept, rn limit 8",
    "select pay, pay - avg(pay) over (partition by dept) as dev from emp",
    "select row_number() over (order by pay) as a, "
    "sum(pay) over (partition by dept) as b from emp",
    "select yr, min(dept) over (partition by yr) as md from emp order by yr",
    "select l.k, l.v, sum(d.w) over (partition by l.k) as sw "
    "from l join d on l.k = d.j",
    "select distinct dept, count(*) over (partition by dept) as n from emp "
    "order by dept",
    "select dept, pay, rank() over (partition by dept order by pay) as rk "
    "from emp where yr > 2019 and pay < 120 order by rk, dept, pay",
    # the known fault, held: count/sum over a NULL argument count the 0-fill
    "select nf.k, nd.m, count(nd.m) over () as c, sum(nd.m) over "
    "(order by nf.k) as s from nf left join nd on nf.k = nd.j",
    # TestWindowsDistributed's queries (one device here)
    "select dept, pay, rank() over (partition by dept order by pay desc) "
    "as rk from emp3 order by dept, pay",
    "select dept, sum(pay) over (partition by dept) as tot, "
    "row_number() over (partition by yr order by pay) as rn from emp3",
    "select pay, sum(pay) over () as tot from emp3 where pay > 80",
    "select dept, pay, sum(pay) over (partition by dept order by pay) as rs "
    "from emp3 order by rs desc limit 10",
    "select dept, pay, lead(pay, 1, -999) over "
    "(partition by dept order by pay) as nx from emp3 order by dept, pay",
    "select pay, row_number() over (order by pay desc, yr) as rn, "
    "rank() over (order by pay desc) as rk, "
    "dense_rank() over (order by pay desc) as dr from emp3 order by rn",
    "select pay, sum(pay) over (order by pay, yr) as rs, "
    "count(pay) over (order by pay, yr) as rc, "
    "min(pay) over (order by pay desc) as mn from emp3 order by pay, yr",
    "select pay, first_value(pay) over (order by pay desc) as fv, "
    "last_value(pay) over (order by pay) as lv from emp3 "
    "order by pay, yr limit 20",
    "select pay, sum(pay) over () as t, count(pay) over () as c, "
    "max(pay) over () as mx from emp3 where pay > 70 order by pay, yr",
    "select pay, lag(pay, 1, -3) over (order by pay, yr) as lg "
    "from emp3 order by pay, yr",
    "select pay, lead(pay, 3, -9) over (order by pay desc, yr) as ld, "
    "lag(yr, 2) over (order by pay desc, yr) as lg2 "
    "from emp3 order by pay desc, yr",
    # TestWindowsOverGroupedOutput
    "select dept, yr, sum(pay) as tot, "
    "rank() over (order by sum(pay) desc) as rk, "
    "sum(sum(pay)) over (partition by dept) as dept_tot "
    "from emp group by dept, yr order by rk, dept, yr",
    "select dept, yr, count(*) as n, "
    "row_number() over (order by count(*) desc, dept, yr) as rn "
    "from emp group by dept, yr having count(*) > 8 order by rn",
    "select dept, avg(pay) as a, rank() over (order by avg(pay) desc) as rk "
    "from emp group by dept order by rk, dept",
    "select dept, reg, sum(pay) as tot, "
    "rank() over (order by sum(pay) desc) as rk "
    "from g group by dept, reg order by rk, dept, reg",
    "select dept, reg, count(*) as n, row_number() over "
    "(partition by dept order by count(*) desc, reg) as rn "
    "from g group by dept, reg having count(*) > 20 order by dept, rn",
    # grouped windows without ORDER BY (the JAX package computes them
    # before HAVING and again after it; the port once, after it)
    "select dept, yr, sum(pay) as tot, "
    "dense_rank() over (partition by yr order by sum(pay)) as dr "
    "from emp group by dept, yr having sum(pay) > 500",
    # TestPositionalWindowFuncs
    "select dept, yr, pay, "
    "lag(pay) over (partition by dept order by yr, pay) as prev, "
    "lead(pay, 2) over (partition by dept order by yr, pay) as nxt "
    "from emp order by dept, yr, pay",
    "select lag(pay, 1, -1) over (order by pay, yr) as p from emp "
    "order by pay, yr limit 1",
    "select dept, yr, pay, "
    "lead(pay, 1, -999) over (partition by dept order by yr, pay) "
    "as nxt from emp order by dept, yr, pay",
    "select pay, lead(pay, 2, -5) over (order by pay, yr) as nxt "
    "from emp where pay > 90 order by pay, yr",
    "select lag(pay, 100000) over (partition by dept) as p from emp",
    "select dept, pay, "
    "first_value(pay) over (partition by dept order by pay) as fv "
    "from emp order by dept, pay",
    "select lag(dept) over (order by pay, yr, f) as pd from emp "
    "order by pay, yr, f",
    "select dept, first_value(f) over (partition by yr order by pay desc) "
    "as ff, last_value(dept) over (partition by yr order by pay) as ld, "
    "lead(f, 2, 0.5) over (partition by dept order by f) as lf from emp",
    "select k, t, lag(v) over (partition by k order by t) as p, "
    "first_value(v) over (partition by k order by t) as fv "
    "from s order by k, t",
]


@pytest.mark.parametrize("query", CASES)
def test_window_query_matches_jax(query):
    j, p = _contexts()
    assert_query_same(j, p, query)


ERRORS = [
    "select pay from emp where row_number() over (order by pay) < 5",
    "select sum(pay), row_number() over (order by sum(pay)) from emp",
    "select sum(dept) over () from emp",
    "select count(distinct pay) over () from emp",
    "select row_number() from emp",
    "select lag(pay, -1) over (order by pay) from emp",
    "select lag(dept, 1, 5) over (order by pay) from emp",
    "select dept, sum(pay) from emp group by dept having "
    "rank() over (order by sum(pay)) < 2",
    "select yr, rank() over (order by pay) from emp group by yr",
]


@pytest.mark.parametrize("query", ERRORS)
def test_window_error_matches_jax(query):
    j, p = _contexts()
    assert_error_same(j, p, query)


def test_window_explain_matches_jax():
    j, p = _contexts()
    q = ("select dept, row_number() over (order by pay) as a, "
         "sum(pay) over (partition by dept) as b, "
         "rank() over (partition by dept) as c from emp order by a")
    assert p.explain(q) == j.explain(q)
    assert "over 2 shape(s)" in p.explain(q)
