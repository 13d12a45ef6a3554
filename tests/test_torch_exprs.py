"""harkdb_tpu_torch expressions and aggregates vs harkdb_tpu, on the CPU.

The queries of tests/test_exprs.py (CASE, ABS, reserved keywords, ORDER
BY aliases, FLOOR / CEIL / ROUND half away from zero, SQRT, rejections),
tests/test_sql_ext.py ``TestGroupByExpr``, ``TestSimpleCase``,
``TestVarianceFamily``, ``TestMedianQuantile`` and ``TestTopKLimit`` (their
mesh cases left out) and tests/test_parity.py ``TestGroupKeyOrder`` (its
mesh case left out) under both settings of ``compat_u32_key_order``, run
through ``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built from
the same seeds as there. Each query's raw matrix must be identical
(integers bit for bit, float32 within rtol=1e-6, atol=0), its ``sql_df``
frame equal with NaN in the same places; each error case must raise the
same exception type with the same text. Where the JAX tests check against
pandas (``TestTopKLimit``), the port is held against the JAX package's
output, which those tests tie to pandas.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.ops.groupby import groupby_aggregate as jax_groupby_aggregate
from harkdb_tpu_torch.ops.groupby import groupby_aggregate

from test_torch_derived import assert_error_same, assert_query_same, \
    make_pair


def _ctx():
    """tests/test_exprs.py's ``ctx`` (seed 0)."""
    rng = np.random.default_rng(0)
    n = 400
    return {"t": pd.DataFrame({
        "k": rng.integers(0, 7, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int32),
        "w": rng.integers(1, 50, n).astype(np.int32),
    })}


def _floats():
    """test_abs_float / test_rounding_on_floats (seed 0), the half-way
    values of test_round_half_away_from_zero, the keyword table and the
    string table of test_on_strings_rejected."""
    rng = np.random.default_rng(0)
    return {
        "t": pd.DataFrame({
            "f": (rng.standard_normal(200) * 10).astype(np.float32)}),
        "h": pd.DataFrame(
            {"f": np.array([2.5, -2.5, 3.5, -0.5, 0.5], np.float32)}),
        "kw": pd.DataFrame({"v": np.array([1, 2], np.int32)}),
        "s": pd.DataFrame({"x": ["a", "b"]}),
    }


def _tctx():
    """tests/test_sql_ext.py's ``tctx``, with the one-row table and the
    nullable pair (f, d) of TestVarianceFamily."""
    return {
        "t": pd.DataFrame({"k": np.array([1, 1, 2, 2, 3], np.int32),
                           "v": np.array([10, 20, 30, 40, 50], np.int32)}),
        "r": pd.DataFrame({"k": np.array([1, 1, 2], np.int32),
                           "w": np.array([5, 15, 100], np.int32)}),
        "u": pd.DataFrame({"k": [1], "v": [7]}),
        "f": pd.DataFrame({"k": np.int32([1, 2, 3])}),
        "d": pd.DataFrame({"j": np.int32([1, 1, 2]),
                           "m": np.int32([10, 20, 5])}),
        # TestMedianQuantile.test_nullable_skips
        "qd": pd.DataFrame({"j": np.int32([1, 1, 1, 2]),
                            "m": np.int32([10, 20, 30, 7])}),
        # TestTopKLimit.test_nullable_key
        "kf": pd.DataFrame({"k": np.int32([1, 2, 3, 4])}),
        "kd": pd.DataFrame({"j": np.int32([1, 2]), "m": np.int32([9, 5])}),
    }


def _vctx():
    """TestVarianceFamily's ``vctx`` (seed 0)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        "k": rng.integers(0, 6, 200).astype(np.int32),
        "v": rng.integers(0, 100, 200).astype(np.int32),
    })}


def _qctx():
    """TestMedianQuantile's ``qctx`` (seed 0)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        "k": rng.integers(0, 8, 300).astype(np.int32),
        "v": rng.integers(0, 1000, 300).astype(np.int32),
    })}


def _kctx():
    """TestTopKLimit's ``kctx`` (seed 0)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        "k": rng.integers(0, 500, 5000).astype(np.int32),
        "v": rng.integers(-500, 500, 5000).astype(np.int32),
        "f": rng.normal(0, 10, 5000).astype(np.float32),
    })}


SETS = {"e": _ctx, "f": _floats, "t": _tctx, "var": _vctx, "q": _qctx,
        "k": _kctx}

_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        _CONTEXTS[name] = make_pair(SETS[name]())
    return _CONTEXTS[name]


CASES = [
    # tests/test_exprs.py TestCase
    ("e", "select case when v > 50 then 2 when v > 0 then 1 "
          "else 0 end as b from t"),
    ("e", "select case when v > 50 then 7 when v < -50 then 3 end as b "
          "from t"),
    ("e", "select k, sum(case when v > 0 then w else 0 end) as s "
          "from t group by k order by k"),
    ("e", "select v from t where case when w > 25 then v > 0 "
          "else v < 0 end"),
    # TestAbs
    ("e", "select abs(v) as a from t"),
    ("f", "select abs(f) as a from t"),
    ("e", "select k, sum(abs(v)) as s from t where abs(v) > 10 "
          "group by k order by k"),
    # TestKeywordHygiene
    ("f", "select v from kw union all select v from kw"),
    # TestOrderByAlias
    ("e", "select k, sum(v) as s from t group by k order by s desc"),
    ("e", "select v as w, w as x from t order by w, x"),
    # TestScalarFuncs
    ("f", "select floor(f) as fl, ceil(f) as ce, round(f) as ro from t"),
    ("f", "select round(f) as r from h"),
    ("e", "select floor(v) as a, ceil(v) as b from t"),
    ("e", "select sqrt(abs(v)) as s from t"),
    ("e", "select v from t where sqrt(abs(v)) > 5"),
    # tests/test_sql_ext.py TestGroupByExpr
    ("t", "select v % 20 as b, count(*) as n, sum(v) as s from t "
          "group by v % 20 order by b"),
    ("t", "select case when v < 25 then 0 else 1 end as b, "
          "count(*) as n from t group by "
          "case when v < 25 then 0 else 1 end order by b"),
    ("t", "select v % 20 as b, sum(v) as s from t group by v % 20 "
          "having sum(v) > 70 order by v % 20"),
    ("t", "select k, v % 20 as b, count(*) as n from t "
          "group by k, v % 20 order by k, b"),
    ("t", "select r.w % 10 as b, count(*) as n from t "
          "left join r on t.k = r.k group by r.w % 10 "
          "order by b nulls last"),
    # TestSimpleCase
    ("t", "select k, case k when 1 then 10 when 2 then 20 else -1 end "
          "as c from t group by k order by k"),
    ("t", "select v, case v % 20 when 0 then 1 else 0 end as c "
          "from t order by v"),
    # TestVarianceFamily
    ("var", "select k, stddev(v) as sd, variance(v) as va, "
            "stddev_pop(v) as sp, var_pop(v) as vp from t "
            "group by k order by k"),
    ("t", "select k, stddev(v) as sd, var_pop(v) as vp from u group by k"),
    ("t", "select f.k, stddev(d.m) as sd from f "
          "left join d on f.k = d.j group by f.k order by f.k"),
    ("var", "select k, variance(v) as va from t group by k "
            "having variance(v) > 0 order by va desc"),
    # TestMedianQuantile
    ("q", "select k, median(v) as md, quantile(v, 0.25) as q1, "
          "quantile(v, 0.9) as q9 from t group by k order by k"),
    ("q", "select quantile(v, 0) as lo, quantile(v, 1) as hi, "
          "median(v) as md from t"),
    ("t", "select f.k, median(qd.m) as md from f "
          "left join qd on f.k = qd.j group by f.k order by f.k"),
    # TestTopKLimit (the top-k path in both packages up to a LIMIT of
    # 1024, the sort above it; tests/test_torch_topk.py holds the gate)
    ("k", "select k, v from t order by v limit 7"),
    ("k", "select k, v from t order by v desc limit 7"),
    ("k", "select k, f from t order by f limit 6"),
    ("k", "select k, v from t where v > 0 order by v desc "
          "limit 5 offset 2"),
    ("k", "select k, v from t order by v limit 800"),
    ("k", "select k, v from t order by v limit 2000"),
    ("t", "select kf.k, kd.m from kf left join kd on kf.k = kd.j "
          "order by kd.m limit 3"),
    ("t", "select kf.k, kd.m from kf left join kd on kf.k = kd.j "
          "order by kd.m desc nulls last limit 3"),
]


@pytest.mark.parametrize("tables,query", CASES)
def test_expr_query_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_query_same(j, p, query)


ERRORS = [
    ("f", "select union from kw"),
    ("e", "select v from t order by nosuch"),
    *[("f", f"select {fn}(x) from s")
      for fn in ("floor", "ceil", "round", "sqrt")],
    ("var", "select stddev(v) over (order by v) from t"),
    ("q", "select quantile(v, 2) from t"),
    ("q", "select median(v) over (order by v) from t"),
]


@pytest.mark.parametrize("tables,query", ERRORS)
def test_expr_error_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_error_same(j, p, query)


# -- tests/test_parity.py TestGroupKeyOrder, under both key orders -----------

def _neg_key_frame():
    return pd.DataFrame({
        "k": np.array([3, -2, 0, -2, 3, -1, 0, 7], np.int32),
        "v": np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32),
    })


def _nonneg_frame():
    """test_compat_matches_default_for_nonnegative_keys (seed 7)."""
    rng = np.random.default_rng(7)
    return pd.DataFrame({
        "k": rng.integers(0, 50, 400).astype(np.int32),
        "v": rng.integers(-9, 9, 400).astype(np.int32),
    })


KEY_ORDER = [
    ("neg", "select k, sum(v) from t group by k"),
    ("neg", "select k, sum(v), min(v) from t group by k"),
    ("neg", "select k, count(*), max(v) from t where v > 2 group by k"),
    ("neg", "select distinct k from t"),
    ("nonneg", "select k, sum(v), count(v), max(v) from t group by k"),
]


@pytest.mark.parametrize("u32", [False, True])
@pytest.mark.parametrize("frame,query", KEY_ORDER)
def test_group_key_order_matches_jax(frame, query, u32):
    df = _neg_key_frame() if frame == "neg" else _nonneg_frame()
    j = harkdb_tpu.Context(harkdb_tpu.EngineConfig(compat_u32_key_order=u32))
    p = harkdb_tpu_torch.Context(
        harkdb_tpu_torch.EngineConfig(compat_u32_key_order=u32),
        device="cpu")
    for c in (j, p):
        c.create_table("t", df)
    assert_query_same(j, p, query)
    if query == KEY_ORDER[0][1]:
        want = [0, 3, 7, -2, -1] if u32 else [-2, -1, 0, 3, 7]
        assert p.sql(query)[:, 0].tolist() == want


def test_direct_aggregate_u32_order():
    """test_direct_aggregate_u32_order: the operator itself, both
    packages."""
    keys = np.array([5, -5, 5, 0, -5], np.int32)
    vals = np.array([1, 2, 3, 4, 5], np.int32)
    jk, jo, jn = jax_groupby_aggregate(
        jnp.asarray(keys), [(jnp.asarray(vals), "sum")], jnp.int32(5),
        u32_key_order=True)
    tk, to, tn = groupby_aggregate(
        torch.from_numpy(keys), [(torch.from_numpy(vals), "sum")],
        torch.tensor(5, dtype=torch.int32), u32_key_order=True)
    assert int(tn) == int(jn) == 3
    np.testing.assert_array_equal(tk[0][:3].numpy(), np.asarray(jk[0])[:3])
    np.testing.assert_array_equal(to[0][:3].numpy(), np.asarray(jo[0])[:3])
    assert tk[0][:3].tolist() == [0, 5, -5]
