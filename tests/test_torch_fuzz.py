"""harkdb_tpu_torch on tests/test_fuzz.py's randomized queries, part 1.

The single-table, join and new-feature fuzzers of tests/test_fuzz.py
(``test_fuzz_ungrouped``, ``test_fuzz_grouped``, ``test_fuzz_join``,
``test_fuzz_all_rows_masked_grouped``, ``test_fuzz_left_join_where``,
``test_fuzz_new_features``), with the same seeds, tables and queries, run
through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")``. The JAX package's own tests tie
its output to pandas; here the port's raw matrix must equal the JAX
package's (integers bit for bit, float32 within rtol=1e-6, atol=0) and its
``sql_df`` frame must be equal. The table and predicate generators are
test_fuzz.py's own. Part 2 (strings, set operations, subqueries, NULLs,
join kinds) is tests/test_torch_fuzz_surface.py: the two files split the
corpus's time between xdist workers.
"""

import numpy as np
import pytest

from test_fuzz import _PREDS, _make_tables
from test_torch_derived import assert_query_same, make_pair


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_ungrouped_matches_jax(seed):
    rng = np.random.default_rng(1000 + seed)
    t1, _ = _make_tables(rng, int(rng.integers(1, 200)))
    sql_pred, _ = _PREDS[seed % len(_PREDS)]
    order_col = ["a", "b", "c"][seed % 3]
    desc = bool(seed % 2)
    sel = "distinct a, b" if seed % 4 == 0 else "a, b, c"
    q = (f"select {sel} from t1 where {sql_pred} "
         f"order by {order_col} {'desc' if desc else 'asc'}")
    assert_query_same(*make_pair({"t1": t1}), q)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_grouped_matches_jax(seed):
    rng = np.random.default_rng(2000 + seed)
    t1, _ = _make_tables(rng, int(rng.integers(1, 300)))
    sql_pred, _ = _PREDS[(seed + 1) % len(_PREDS)]
    key_sql = "a" if seed % 2 else "a, b"
    q = (f"select {key_sql}, sum(c), min(b), max(c), count(*), avg(f) "
         f"from t1 where {sql_pred} group by {key_sql}"
         + (" having count(*) > 1" if seed % 3 == 0 else "")
         + f" order by {key_sql}")
    assert_query_same(*make_pair({"t1": t1}), q)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_join_matches_jax(seed):
    rng = np.random.default_rng(3000 + seed)
    t1, t2 = _make_tables(rng, int(rng.integers(1, 150)))
    sql_pred, _ = _PREDS[seed % len(_PREDS)]
    if seed % 2 == 0:
        q = (f"select a, sum(w), count(*) from t1 "
             f"join t2 on t1.a = t2.j where {sql_pred} "
             f"group by a order by a")
    else:
        q = (f"select a, b, w from t1 join t2 on t1.a = t2.j "
             f"where {sql_pred} order by c")
    assert_query_same(*make_pair({"t1": t1, "t2": t2}), q)


def test_fuzz_all_rows_masked_grouped_matches_jax():
    rng = np.random.default_rng(7)
    t1, _ = _make_tables(rng, 64)
    j, p = make_pair({"t1": t1})
    q = "select a, sum(b) from t1 where b > 1000 group by a order by a"
    assert_query_same(j, p, q)
    assert p.sql(q).shape == (0, 2)


def test_fuzz_left_join_where_matches_jax():
    rng = np.random.default_rng(11)
    t1, t2 = _make_tables(rng, 80)
    t2 = t2[t2.j < 4]                       # some t1.a values unmatched
    q = ("select a, b, w from t1 left join t2 on t1.a = t2.j where b > 0 "
         "order by a")
    assert_query_same(*make_pair({"t1": t1, "t2": t2}), q)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_new_features_matches_jax(seed):
    rng = np.random.default_rng(4000 + seed)
    t1, _ = _make_tables(rng, int(rng.integers(1, 300)))
    sql_pred, _ = _PREDS[seed % len(_PREDS)]
    q = (f"select a, count(distinct b), sum(case when b > 0 then c "
         f"else 0 end), max(abs(b)) from t1 where {sql_pred} "
         f"group by a order by a")
    assert_query_same(*make_pair({"t1": t1}), q)
