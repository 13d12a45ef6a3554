"""harkdb_tpu_torch set operations vs harkdb_tpu, on the CPU.

The queries of tests/test_union.py and the INTERSECT / EXCEPT cases of
tests/test_sql_ext.py run through ``harkdb_tpu.Context`` (JAX on the CPU)
and ``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built
from the same seeds as there: UNION ALL, UNION (dedupe at every non-ALL
junction, left-associative), INTERSECT and EXCEPT (NULLs compare equal),
the trailing ORDER BY by name or ordinal with OFFSET / LIMIT, int/float
promotion with its exact-integer-span guard, and the position-wise string
dictionary merge. Outputs must be identical (integers bit for bit,
float32 within rtol=1e-6, atol=0), errors equal in type and text.
"""

import numpy as np
import pandas as pd
import pytest

from test_torch_derived import assert_error_same, assert_query_same, make_pair


def _uctx():
    """tests/test_union.py's ``uctx`` (rng seed 0), its lossy-cast and
    string tables, and the distributed tests' tables (rng seed 0)."""
    rng = np.random.default_rng(0)
    a = pd.DataFrame({"k": rng.integers(0, 6, 200).astype(np.int32),
                      "v": rng.integers(-40, 40, 200).astype(np.int32)})
    b = pd.DataFrame({"k": rng.integers(3, 9, 150).astype(np.int32),
                      "v": rng.integers(-40, 40, 150).astype(np.int32)})
    rng = np.random.default_rng(0)
    a2 = pd.DataFrame({"k": rng.integers(0, 9, 400).astype(np.int32),
                       "v": rng.integers(0, 100, 400).astype(np.int32)})
    b2 = pd.DataFrame({"k": rng.integers(4, 12, 250).astype(np.int32),
                       "v": rng.integers(0, 100, 250).astype(np.int32)})
    rng = np.random.default_rng(0)
    s1 = pd.DataFrame({"s": rng.choice(["ant", "bee", "cat"], 200),
                       "n": rng.integers(0, 50, 200).astype(np.int32)})
    s2 = pd.DataFrame({"s": rng.choice(["bee", "dog", "elk"], 150),
                       "n": rng.integers(0, 50, 150).astype(np.int32)})
    return {
        "a": a, "b": b, "a2": a2, "b2": b2, "s1": s1, "s2": s2,
        "big": pd.DataFrame({"v": np.int32([1 << 25, 3])}),
        "fl": pd.DataFrame({"v": np.float32([0.5])}),
        "x1": pd.DataFrame({"s": ["x", "y"], "n": [1, 2]}),
        "x2": pd.DataFrame({"s": ["y", "z"], "n": [2, 9]}),
    }


def _soctx():
    """tests/test_sql_ext.py TestSetOps' ``soctx`` with the NULL tables,
    and its distributed tables (rng seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "a": pd.DataFrame({"x": np.int32([1, 2, 2, 3, 4])}),
        "b": pd.DataFrame({"y": np.int32([2, 3, 3, 5])}),
        "f": pd.DataFrame({"k": np.int32([1, 2])}),
        "d": pd.DataFrame({"j": np.int32([1]), "m": np.int32([7])}),
        "t": pd.DataFrame({"x": rng.integers(0, 40, 300).astype(np.int32)}),
        "u": pd.DataFrame({"y": rng.integers(20, 60, 200).astype(np.int32)}),
    }


SETS = {"uctx": _uctx, "soctx": _soctx}
_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        _CONTEXTS[name] = make_pair(SETS[name]())
    return _CONTEXTS[name]


_NULL_ARM = "select d.m from f left join d on f.k = d.j"

CASES = [
    # tests/test_union.py TestUnionAll
    ("uctx", "select k, v from a union all select k, v from b"),
    ("uctx", "select k, v from a where v > 0 "
             "union all select k, v from b where v < 0"),
    ("uctx", "select k from a union all select k from b "
             "union all select k from a"),
    # TestUnionDistinct
    ("uctx", "select k, v from a union select k, v from b"),
    ("uctx", "select k from a union select k from b union all "
             "select k from b"),
    ("uctx", "select k, sum(v) as s from a group by k "
             "union select k, sum(v) as s from b group by k"),
    # TestUnionTail
    ("uctx", "select k, v from a union select k, v from b "
             "order by k desc, v"),
    ("uctx", "select k, v from a union select k, v from b "
             "order by 1 desc, 2"),
    ("uctx", "select k, v from a union select k, v from b order by k, v"),
    ("uctx", "select k, v from a union select k, v from b "
             "order by k, v limit 5 offset 3"),
    ("uctx", "select k, avg(v) as x from a group by k "
             "union all select k, v from a"),
    ("uctx", "select v from big where v < 100 union all select v from fl"),
    # TestUnionStrings
    ("uctx", "select s, n from x1 union select s, n from x2 order by s"),
    # TestUnionDistributed's queries (one device here)
    ("uctx", "select k, sum(v) as s from a2 group by k "
             "union select k, sum(v) as s from b2 group by k order by k, s"),
    ("uctx", "select k, v from a2 union all select k, v from b2"),
    ("uctx", "select k, v from a2 union select k, v from b2 order by k, v"),
    ("uctx", "select k, v from a2 where v > 40 union all "
             "select k, v from b2 order by v desc, k limit 17"),
    ("uctx", "select k from a2 union select k from b2 union all "
             "select k from a2 order by k limit 10 offset 3"),
    ("uctx", "select k, avg(v) as x from a2 group by k "
             "union all select k, v from b2 order by x, k limit 25"),
    ("uctx", "select s, n from s1 union select s, n from s2 "
             "order by s, n limit 30"),
    # tests/test_sql_ext.py TestSetOps
    ("soctx", "select x from a intersect select y from b order by x"),
    ("soctx", "select x from a except select y from b order by x"),
    ("soctx", "select y from b except select x from a"),
    ("soctx", "select x from a union select y from b "
              "except select x from a where x > 3 order by x"),
    ("soctx", f"{_NULL_ARM} intersect {_NULL_ARM} order by m"),
    ("soctx", f"{_NULL_ARM} except select d.m + 1 - 1 from f "
              f"left join d on f.k = d.j"),
    ("soctx", f"{_NULL_ARM} union {_NULL_ARM} order by m desc"),
    ("soctx", f"{_NULL_ARM} union all select x from a "
              f"order by m nulls first"),
    ("soctx", "select x from t intersect select y from u order by x"),
    ("soctx", "select x from t except select y from u order by x desc"),
    ("soctx", "select x from t intersect select y from u "
              "intersect select x from t where x > 30"),
    ("soctx", "select x from t except select y from u limit 4 offset 2"),
]


@pytest.mark.parametrize("tables,query", CASES)
def test_set_operation_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_query_same(j, p, query)


ERRORS = [
    ("uctx", "select v from big union all select v from fl"),
    ("uctx", "select s from x1 union select n from x1"),
    ("uctx", "select k, v from a union select k from b"),
    ("uctx", "select k from a union select k from b order by zzz"),
    ("soctx", "select x from a intersect all select y from b"),
]


@pytest.mark.parametrize("tables,query", ERRORS)
def test_set_operation_error_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_error_same(j, p, query)


@pytest.mark.parametrize("query", [
    "select k, v from a union select k, v from b order by k desc, v "
    "limit 5 offset 2",
    "select k from a intersect select k from b except select k from a "
    "where v > 30",
])
def test_set_operation_explain_matches_jax(query):
    j, p = _contexts("uctx")
    assert p.explain(query) == j.explain(query)
