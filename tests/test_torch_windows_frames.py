"""harkdb_tpu_torch window ROWS frames, NTILE / PERCENT_RANK / CUME_DIST /
NTH_VALUE and sort-order tracking vs harkdb_tpu, on the CPU.

The queries of tests/test_windows.py TestFrameSpecs, TestFramesFollowing
and TestSortOrderTracking run through ``harkdb_tpu.Context`` (JAX on the
CPU) and ``harkdb_tpu_torch.Context(device="cpu")`` over the same tables,
built from the same seeds as there: bounded and unbounded ROWS frames
(sliding min/max, suffix scans, the empty-frame ``#winvalid*`` NULLs), and
the ORDER BY that matches a window shape's sort (the plan's
``window_skip_shape`` must equal the JAX package's). Outputs must be
identical (integers bit for bit, float32 within rtol=1e-6, atol=0), errors
equal in type and text.
"""

import numpy as np
import pandas as pd
import pytest

from test_torch_derived import assert_error_same, assert_query_same, make_pair
from test_torch_windows import emp


def _tables():
    rng = np.random.default_rng(0)
    tk = pd.DataFrame({"k": rng.integers(0, 25, 400).astype(np.int32),
                       "v": rng.integers(0, 40, 400).astype(np.int32)})
    rng = np.random.default_rng(0)
    ft = pd.DataFrame({"k": rng.integers(0, 6, 120).astype(np.int32),
                       "v": rng.integers(0, 100, 120).astype(np.int32)})
    rng = np.random.default_rng(0)
    fe = pd.DataFrame({"dept": rng.choice(["a", "b", "c"], 300),
                       "pay": rng.integers(0, 200, 300).astype(np.int32)})
    return {
        "emp": emp(200), "tk": tk, "ft": ft, "fe": fe,
        "five": pd.DataFrame({"v": np.int32([5, 5, 5])}),
        "d": pd.DataFrame({"j": np.int32([0, 1]), "m": np.int32([7, 9])}),
    }


_CONTEXTS = {}


def _contexts():
    if not _CONTEXTS:
        _CONTEXTS["f"] = make_pair(_tables())
    return _CONTEXTS["f"]


def _frame(func, frame_sql):
    """TestFramesFollowing._check's query shape."""
    return (f"select k, v, {func}(v) over (partition by k "
            f"order by v, k rows between {frame_sql}) as o "
            f"from ft order by k, v")


_TK = ("select k, v, sum(v) over (partition by k order by v) as rs, "
       "row_number() over (partition by v order by k desc) as rn from tk ")

CASES = [
    # TestFrameSpecs
    "select dept, pay, "
    "sum(pay) over (partition by dept order by pay, yr "
    "rows between 2 preceding and current row) as s, "
    "avg(pay) over (partition by dept order by pay, yr "
    "rows between 2 preceding and current row) as a, "
    "count(pay) over (partition by dept order by pay, yr "
    "rows between 2 preceding and current row) as n "
    "from emp order by dept, pay, yr",
    "select dept, pay, "
    "min(pay) over (partition by dept order by yr, pay "
    "rows between 4 preceding and current row) as mn, "
    "max(f) over (partition by dept order by yr, pay "
    "rows between 4 preceding and current row) as mx "
    "from emp order by dept, yr, pay",
    "select sum(v) over (order by v rows between unbounded "
    "preceding and current row) as s from five",
    "select sum(v) over (order by v) as s from five",
    "select dept, pay, sum(pay) over (partition by dept "
    "order by pay rows between 3 preceding and current row) as s "
    "from fe order by dept, pay",
    "select pay, max(pay) over (order by pay "
    "rows between 2 preceding and current row) as m "
    "from fe order by pay",
    "select dept, f, min(f) over (partition by dept order by pay, yr "
    "rows between 300 preceding and 2 following) as mn, "
    "prod(pay % 2 + 1) over (partition by yr order by pay, f rows between "
    "unbounded preceding and 1 following) as pr from emp",
    # TestFramesFollowing._check
    _frame("sum", "1 preceding and 2 following"),
    _frame("count", "1 preceding and 2 following"),
    _frame("min", "2 preceding and 1 following"),
    _frame("max", "current row and 3 following"),
    _frame("max", "current row and unbounded following"),
    _frame("sum", "unbounded preceding and 2 following"),
    _frame("sum", "unbounded preceding and unbounded following"),
    _frame("min", "3 preceding and unbounded following"),
    _frame("sum", "2 following and 4 following"),
    _frame("sum", "4 preceding and 2 preceding"),
    _frame("avg", "2 following and 4 following"),
    _frame("count", "4 preceding and 2 preceding"),
    _frame("min", "unbounded preceding and 2 following"),
    _frame("max", "unbounded preceding and unbounded following"),
    "select k, v, avg(v) over (partition by k order by v, k "
    "rows between 1 preceding and 1 following) as a from ft order by k, v",
    "select k, v, ntile(4) over (partition by k order by v, k) as nt, "
    "percent_rank() over (partition by k order by v) as pr, "
    "cume_dist() over (partition by k order by v) as cd "
    "from ft order by k, v",
    "select k, v, nth_value(v, 3) over (partition by k "
    "order by v, k) as n3 from ft order by k, v",
    "select k, v, sum(v) over (partition by k order by v, k rows "
    "between 1 preceding and 2 following) as s from ft order by k, v",
    "select k, v, ntile(3) over (partition by k order by v, k) "
    "as nt, nth_value(v, 2) over (partition by k order by v, k) "
    "as n2 from ft order by k, v",
    "select k, v, sum(v) over (partition by k order by v, k rows "
    "between 2 following and 4 following) as s2 from ft order by k, v",
    "select v, ntile(7) over (order by v desc) as nt, "
    "percent_rank() over () as pr, cume_dist() over (order by k) as cd, "
    "nth_value(k, 50) over (order by v) as n50 from ft",
    # TestSortOrderTracking
    _TK + "order by k, v",
    _TK + "order by k, v, rn",
    _TK + "order by k, v limit 7 offset 3",
    "select k, v, sum(v) over (partition by k order by v desc) "
    "as rs from tk order by k, v desc",
    "select tk.k, d.m, sum(tk.v) over (partition by d.m order by tk.k)"
    " as rs from tk left join d on tk.k = d.j order by d.m, tk.k",
    "select k, v, min(v) over (partition by k order by v) as mn from tk "
    "where v > 20 order by k, v",
]


@pytest.mark.parametrize("query", CASES)
def test_window_frame_query_matches_jax(query):
    j, p = _contexts()
    assert_query_same(j, p, query)
    # the two packages' AST classes differ; their reprs do not
    assert (repr(p._plan(query).window_skip_shape)
            == repr(j._plan(query).window_skip_shape))


ERRORS = [
    "select row_number() over (order by pay rows between "
    "2 preceding and current row) from emp",
    "select sum(pay) over (order by pay range between "
    "2 preceding and current row) as s from emp",
    "select prod(v) over (order by v rows between 2 "
    "preceding and current row) from ft",
    "select min(v) over (order by v rows between 2 "
    "following and 4 following) from ft",
    "select ntile(0) over (order by v) from ft",
    "select nth_value(v, 0) over (order by v) from ft",
]


@pytest.mark.parametrize("query", ERRORS)
def test_window_frame_error_matches_jax(query):
    j, p = _contexts()
    assert_error_same(j, p, query)


def test_sort_order_tracking_engages():
    """tests/test_windows.py TestSortOrderTracking: the matching ORDER BY
    takes the presorted exit on both packages, the extra key does not."""
    j, p = _contexts()
    assert p._plan(_TK + "order by k, v").window_skip_shape is not None
    assert p._plan(_TK + "order by k, v, rn").window_skip_shape is None
    q = ("select tk.k, d.m, sum(tk.v) over (partition by d.m order by tk.k)"
         " as rs from tk left join d on tk.k = d.j order by d.m, tk.k")
    assert p._plan(q).window_skip_shape is None
    assert p.explain(_TK + "order by k, v") == j.explain(_TK + "order by k, v")
