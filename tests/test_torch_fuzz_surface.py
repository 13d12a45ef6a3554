"""harkdb_tpu_torch on tests/test_fuzz.py's randomized queries, part 2.

The surface fuzzers of tests/test_fuzz.py (``test_fuzz_strings`` without
its mesh branch, ``test_fuzz_union_subquery``, ``test_fuzz_round4_surface``,
``test_fuzz_3vl_where``, ``test_fuzz_null_aggregates``,
``test_fuzz_join_kinds``), with the same seeds, tables and queries, run
through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")``; the port must give the JAX
package's raw matrix (integers bit for bit, float32 within rtol=1e-6,
atol=0) and ``sql_df`` frame (NaN / None in the same places). The two mesh
fuzzers (``test_fuzz_distributed_matches_single``,
``test_fuzz_3vl_distributed_parity``) wait for the port of ``parallel/``.
Part 1 is tests/test_torch_fuzz.py.
"""

import numpy as np
import pandas as pd
import pytest

from test_fuzz import _NULLABLE_PREDS, _PREDS, _SPREDS, _WORDS, _make_tables
from test_torch_derived import assert_query_same, make_pair


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_strings_matches_jax(seed):
    rng = np.random.default_rng(6000 + seed)
    n = int(rng.integers(1, 300))
    t1 = pd.DataFrame({
        "s": rng.choice(_WORDS, n),
        "b": rng.integers(-8, 9, n).astype(np.int32),
        "c": rng.integers(0, 50, n).astype(np.int32),
    })
    sql_pred, _ = _SPREDS[seed % len(_SPREDS)]
    q = (f"select s, sum(c), count(distinct b), min(s), max(b) from t1 "
         f"where {sql_pred} group by s order by s")
    assert_query_same(*make_pair({"t1": t1}), q)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_union_subquery_matches_jax(seed):
    rng = np.random.default_rng(7000 + seed)
    t1, t2 = _make_tables(rng, int(rng.integers(20, 300)))
    j, p = make_pair({"t1": t1, "t2": t2})
    p1, _ = _PREDS[seed % len(_PREDS)]
    p2, _ = _PREDS[(seed + 2) % len(_PREDS)]
    q = (f"select a, b from t1 where {p1} "
         f"union {'all ' if seed % 2 == 0 else ''}select a, b from t1 "
         f"where {p2} order by a, b")
    assert_query_same(j, p, q)
    q2 = ("select a, c from t1 where c > (select avg(c) from t1) "
          "and a in (select j from t2 where w > 0)")
    assert_query_same(j, p, q2)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_round4_surface_matches_jax(seed):
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.integers(40, 400))
    t1, _ = _make_tables(rng, n)
    t2 = pd.DataFrame({
        "j": rng.permutation(12)[:6].astype(np.int32),   # half the keys miss
        "w": rng.integers(1, 30, 6).astype(np.int32),
    })
    sql_pred, _ = _PREDS[seed % len(_PREDS)]
    kind = seed % 4
    if kind == 0:
        q = (f"select a, count(w) as cw, sum(coalesce(w, -2)) as s "
             f"from t1 left join t2 on t1.a = t2.j where {sql_pred} "
             f"group by a order by a")
    elif kind == 1:
        neg = "not " if seed % 2 else ""
        q = (f"select count(*) from t1 where {neg}exists "
             f"(select 1 from t2 where t2.j = t1.a) and ({sql_pred})")
    elif kind == 2:
        q = (f"select count(*), sum(d.s) from "
             f"(select a, b, sum(c) as s from t1 where {sql_pred} "
             f"group by a, b) d where d.s > 20")
    else:
        k = 1 + seed % 4
        q = (f"select a, sum(c) as s, "
             f"sum(sum(c)) over (order by a rows between {k} preceding "
             f"and current row) as fr from t1 group by a order by a")
    assert_query_same(*make_pair({"t1": t1, "t2": t2}), q)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_3vl_where_matches_jax(seed):
    rng = np.random.default_rng(7000 + seed)
    n = int(rng.integers(5, 250))
    t1 = pd.DataFrame({
        "a": rng.integers(0, 14, n).astype(np.int32),   # keys 8-13 unmatched
        "b": rng.integers(-8, 9, n).astype(np.int32),
    })
    t2 = pd.DataFrame({
        "j": rng.permutation(8).astype(np.int32),
        "w": rng.integers(-5, 20, 8).astype(np.int32),
    })
    sql_pred, _ = _NULLABLE_PREDS[seed % len(_NULLABLE_PREDS)]
    q = (f"select l.a, l.b from l left join r on l.a = r.j "
         f"where {sql_pred} order by l.a, l.b")
    assert_query_same(*make_pair({"l": t1, "r": t2}), q)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_null_aggregates_matches_jax(seed):
    rng = np.random.default_rng(7100 + seed)
    n = int(rng.integers(10, 300))
    t1 = pd.DataFrame({
        "a": rng.integers(0, 12, n).astype(np.int32),
        "b": rng.integers(-8, 9, n).astype(np.int32),
    })
    t2 = pd.DataFrame({
        "j": rng.permutation(6).astype(np.int32),
        "w": rng.integers(-5, 20, 6).astype(np.int32),
    })
    agg = ["sum", "avg", "min", "max"][seed % 4]
    q = (f"select l.a, {agg}(r.w) as x, count(r.w) as c from l "
         f"left join r on l.a = r.j group by l.a order by l.a")
    assert_query_same(*make_pair({"l": t1, "r": t2}), q)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_join_kinds_matches_jax(seed):
    rng = np.random.default_rng(7200 + seed)
    nl, nr = int(rng.integers(5, 200)), int(rng.integers(5, 120))
    a = pd.DataFrame({
        "u": rng.integers(0, 9, nl).astype(np.int32),
        "v": rng.integers(0, 4, nl).astype(np.int32),
        "x": rng.integers(-50, 50, nl).astype(np.int32),
    })
    b = pd.DataFrame({
        "p": rng.integers(0, 9, nr).astype(np.int32),
        "q": rng.integers(0, 5, nr).astype(np.int32),
        "w": rng.integers(0, 100, nr).astype(np.int32),
    })
    kind = ["join", "left join", "right join", "full outer join"][seed % 4]
    on_sql = "a.u = b.p and a.v = b.q" if seed % 2 == 0 else "a.u = b.p"
    q = (f"select a.x, b.w from a {kind} b on {on_sql} "
         f"order by a.x nulls last, b.w nulls last")
    assert_query_same(*make_pair({"a": a, "b": b}), q)
