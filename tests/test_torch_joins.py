"""harkdb_tpu_torch joins vs harkdb_tpu, on the CPU: the join corpus.

The join queries of tests/test_joins_ext.py (multi-key, RIGHT, FULL OUTER,
CROSS), tests/test_nulls.py and tests/test_nulls3vl.py run through
``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built from
the same seeds as there. Each query's raw matrix must be identical (integer
outputs bit for bit, float32 within rtol=1e-6, atol=0), its ``sql_df``
frame equal with NaN / None in the same places, and its plan's dense-path
fields (``fast_agg``, ``fast_candidate``, ``last_fast_span``,
``_probed_fast``) equal to the JAX package's.
"""

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
import harkdb_tpu_torch

I32_MIN = -(1 << 31)


def _ext():
    """tests/test_joins_ext.py's tables (its ``two`` fixture, rng seed 0,
    plus the three-key, small-exact and small-cross tables)."""
    rng = np.random.default_rng(0)
    nl, nr = 300, 180
    a = pd.DataFrame({
        "u": rng.integers(0, 12, nl).astype(np.int32),
        "v": rng.integers(0, 6, nl).astype(np.int32),
        "val": rng.integers(-50, 50, nl).astype(np.int32),
    })
    b = pd.DataFrame({
        "p": rng.integers(0, 12, nr).astype(np.int32),
        "q": rng.integers(0, 8, nr).astype(np.int32),
        "w": rng.integers(0, 100, nr).astype(np.int32),
    })
    rng = np.random.default_rng(0)
    a3 = pd.DataFrame({c: rng.integers(0, 4, 100).astype(np.int32)
                       for c in ("x", "y", "z")})
    b3 = a3.iloc[:30].rename(columns={"x": "x2", "y": "y2", "z": "z2"})
    b3 = b3.assign(w=np.arange(30, dtype=np.int32))
    return {
        "a": a, "b": b, "a3": a3, "b3": b3,
        "sa": pd.DataFrame({"k": np.int32([1, 2]), "x": np.int32([10, 20])}),
        "sb": pd.DataFrame({"j": np.int32([2, 9]), "w": np.int32([7, 8])}),
        "cx": pd.DataFrame({"x": np.int32([1, 2])}),
        "cy": pd.DataFrame({"y": np.int32([10, 20, 30])}),
    }


def _nulls():
    """tests/test_nulls.py's small tables (``nctx``, with ``r2``) and its
    ``big`` pair (rng seed 0)."""
    rng = np.random.default_rng(0)
    nl, nr = 400, 150
    return {
        "a": pd.DataFrame({"k": np.int32([1, 2, 3, 4]),
                           "v": np.int32([10, 20, 30, 40])}),
        "r": pd.DataFrame({"k": np.int32([1, 1, 3]), "w": np.int32([5, 6, 7]),
                           "s": ["x", "y", "z"]}),
        "r2": pd.DataFrame({"k": np.int32([2]), "u": np.int32([99])}),
        "l": pd.DataFrame({"k": rng.integers(0, 60, nl).astype(np.int32),
                           "v": rng.integers(-30, 30, nl).astype(np.int32)}),
        "rb": pd.DataFrame({"j": rng.integers(0, 40, nr).astype(np.int32),
                            "w": rng.integers(1, 100, nr).astype(np.int32)}),
        "cl": pd.DataFrame({"k": np.int32([1, 1, 2])}),
        "cr": pd.DataFrame({"j": np.int32([1, 1]),
                            "w": np.int32([I32_MIN, I32_MIN])}),
        "ga": pd.DataFrame({"k": np.int32([0, 1, 2]),
                            "v": np.int32([10, 20, 30])}),
        "gr": pd.DataFrame({"k": np.int32([0, 1]), "g": np.int32([0, 7])}),
    }


def _nulls3vl():
    """tests/test_nulls3vl.py's tables: ``tctx`` (f, d), ``big`` (l, r;
    rng seed 0), the NULL-join-key chain, and the review-finding pins."""
    rng = np.random.default_rng(0)
    nl, nr = 500, 200
    big_l = pd.DataFrame({"k": rng.integers(0, 80, nl).astype(np.int32),
                          "x": rng.integers(-50, 50, nl).astype(np.int32)})
    big_r = pd.DataFrame({"j": rng.integers(0, 50, nr).astype(np.int32),
                          "m": rng.integers(-100, 100, nr).astype(np.int32)})
    rng = np.random.default_rng(0)
    nf, nd, ne = 300, 120, 60
    chain = {
        "cf": pd.DataFrame({"k": rng.integers(0, 60, nf).astype(np.int32)}),
        "cd": pd.DataFrame({"j": rng.integers(0, 40, nd).astype(np.int32),
                            "m": rng.integers(0, 30, nd).astype(np.int32)}),
        "ce": pd.DataFrame({"z": rng.integers(0, 30, ne).astype(np.int32),
                            "w": rng.integers(0, 9, ne).astype(np.int32)}),
    }
    return {
        "f": pd.DataFrame({"k": np.int32([1, 2, 3, 4]),
                           "x": np.int32([10, 20, 30, 40])}),
        "d": pd.DataFrame({"j": np.int32([1, 2, 2]),
                           "m": np.int32([5, 150, 7])}),
        "l": big_l, "r": big_r,
        "nf": pd.DataFrame({"k": np.int32([1, 2, 3])}),
        "nd": pd.DataFrame({"j": np.int32([1]), "m": np.int32([0])}),
        "ne": pd.DataFrame({"z": np.int32([0, 7]), "w": np.int32([111, 222])}),
        **chain,
        "qa": pd.DataFrame({"k": np.int32([1, 2, 3])}),
        "qr": pd.DataFrame({"k": np.int32([1]), "w": np.int32([10])}),
        "qr2": pd.DataFrame({"k": np.int32([2]), "u": np.int32([20])}),
        "ta": pd.DataFrame({"k": np.int32([0, 1, 2]),
                            "v": np.int32([100, 10, 10])}),
        "tr": pd.DataFrame({"k": np.int32([0, 1]), "w": np.int32([1, 5])}),
        "da": pd.DataFrame({"k": np.int32([1, 2])}),
        "dr": pd.DataFrame({"k": np.int32([2]), "j": np.int32([0])}),
        "ds": pd.DataFrame({"j": np.int32([0]), "w": np.int32([100])}),
    }


SETS = {"ext": _ext, "nulls": _nulls, "nulls3vl": _nulls3vl}

_BIG_3VL = "select l.k, l.x, r.m from l left join r on l.k = r.j where {} " \
           "order by l.k, l.x, r.m"
_QBASE = "from qa left join qr on qa.k = qr.k left join qr2 on qa.k = qr2.k"

CASES = [
    # tests/test_joins_ext.py: TestMultiKey
    ("ext", "select a.u, a.v, a.val, b.w from a join b on a.u = b.p and "
            "a.v = b.q order by a.u, a.v, a.val, b.w"),
    ("ext", "select a.u, a.v, b.w from a left join b on a.u = b.p and "
            "a.v = b.q order by a.u, a.v, b.w"),
    ("ext", "select count(*) as n from a3 join b3 on a3.x = b3.x2 and "
            "a3.y = b3.y2 and a3.z = b3.z2"),
    # TestRightJoin
    ("ext", "select a.u, a.val, b.p, b.q, b.w from a right join b "
            "on a.u = b.p order by b.p, b.w, a.val"),
    ("ext", "select count(*) as n from a right join b on a.u = b.p "
            "where a.val > 0"),
    ("ext", "select count(*) as n from a right join b on a.u = b.p "
            "where a.val is null"),
    # TestFullOuter
    ("ext", "select a.u, a.v, a.val, b.w from a full outer join b "
            "on a.u = b.p and a.v = b.q order by a.u nulls last, a.v, "
            "a.val, b.w"),
    ("ext", "select count(*) as n, count(a.val) as ca, count(b.w) as cb "
            "from a full outer join b on a.u = b.p and a.v = b.q"),
    ("ext", "select sa.k, sa.x, sb.j, sb.w from sa full outer join sb "
            "on sa.k = sb.j order by sa.k nulls last"),
    # TestCross
    ("ext", "select count(*) as n from a cross join b"),
    ("ext", "select cx.x, cy.y from cx cross join cy order by cx.x, cy.y"),
    # TestDistributedParity's queries (single device here)
    ("ext", "select a.u, a.val, b.w from a right join b on a.u = b.p "
            "order by b.p, b.w, a.val"),
    ("ext", "select count(*) as n, sum(a.val) as s from a cross join b"),
    ("ext", "select a.u, sum(b.w) as s, count(*) as n from a left join b "
            "on a.u = b.p and a.v = b.q group by a.u order by a.u"),
    # tests/test_nulls.py
    ("nulls", "select a.k, r.w, r.s from a left join r on a.k = r.k "
              "order by a.k, r.w"),
    ("nulls", "select a.k, r.w from a left join r on a.k = r.k "
              "order by a.k, r.w"),
    ("nulls", "select a.k, r.w + 1 as w1 from a left join r on a.k = r.k "
              "order by a.k, r.w"),
    ("nulls", "select a.v from a left join r on a.k = r.k order by a.k, r.w"),
    ("nulls", "select a.k from a left join r on a.k = r.k "
              "where r.w is null order by a.k"),
    ("nulls", "select a.k from a left join r on a.k = r.k "
              "where r.w is not null order by a.k, r.w"),
    ("nulls", "select a.k, r.s is null as miss from a left join r "
              "on a.k = r.k order by a.k, r.w"),
    ("nulls", "select l.k, count(rb.w) as c, sum(rb.w) as s, avg(rb.w) as av, "
              "count(*) as n from l left join rb on l.k = rb.j "
              "group by l.k order by l.k"),
    ("nulls", "select l.k, min(rb.w) as mn, max(rb.w) as mx from l "
              "left join rb on l.k = rb.j group by l.k order by l.k"),
    ("nulls", "select a.k, count(distinct r.w) as cd from a "
              "left join r on a.k = r.k group by a.k order by a.k"),
    ("nulls", "select cl.k, count(distinct cr.w) as cd from cl "
              "left join cr on cl.k = cr.j group by cl.k order by cl.k"),
    ("nulls", "select a.k, prod(r.w) as p from a left join r on a.k = r.k "
              "group by a.k order by a.k"),
    ("nulls", "select sum(r.w) as s, count(r.w) as c, count(*) as n "
              "from a left join r on a.k = r.k"),
    ("nulls", "select a.k, r.w from a left join r on a.k = r.k "
              "order by r.w, a.k"),
    ("nulls", "select a.k, r.w from a left join r on a.k = r.k "
              "order by r.w desc, a.k"),
    ("nulls", "select a.k, r.w from a left join r on a.k = r.k "
              "order by r.w nulls first, a.k"),
    ("nulls", "select a.k, r.w from a left join r on a.k = r.k "
              "order by r.w desc nulls last, a.k"),
    ("nulls", "select a.k, coalesce(r.w, 6) as cw from a "
              "left join r on a.k = r.k order by cw, a.k"),
    ("nulls", "select l.k, l.v, rb.w from l left join rb on l.k = rb.j "
              "order by rb.w, l.k, l.v limit 60"),
    ("nulls", "select l.k, l.v, rb.w from l left join rb on l.k = rb.j "
              "order by rb.w desc nulls last, l.k, l.v limit 60"),
    ("nulls", "select distinct rb.w from l left join rb on l.k = rb.j "
              "order by rb.w nulls first"),
    ("nulls", "select a.k, coalesce(r.w, -1) as w from a "
              "left join r on a.k = r.k order by a.k, r.w"),
    ("nulls", "select a.k, sum(coalesce(r.w, 100)) as s, "
              "count(coalesce(r.w, 0)) as c from a "
              "left join r on a.k = r.k group by a.k order by a.k"),
    ("nulls", "select a.k, coalesce(r.w, r2.u, 0) as x from a "
              "left join r on a.k = r.k left join r2 on a.k = r2.k "
              "order by a.k, r.w"),
    ("nulls", "select a.k from a left join r on a.k = r.k "
              "where coalesce(r.w, 0) = 0 order by a.k"),
    ("nulls", "select a.k, sum(case when r.w is not null then r.w else -5 "
              "end) as s from a left join r on a.k = r.k "
              "group by a.k order by a.k"),
    ("nulls", "select gr.g, count(*) as n from ga left join gr "
              "on ga.k = gr.k group by gr.g order by gr.g"),
    ("nulls", "select l.k, rb.w, rb.w is null as m from l left join rb "
              "on l.k = rb.j order by l.k, l.v, rb.w"),
    ("nulls", "select l.k from l left join rb on l.k = rb.j "
              "where rb.w is null order by l.k, l.v"),
    ("nulls", "select l.k, count(rb.w) as c, sum(rb.w) as s, min(rb.w) as mn "
              "from l left join rb on l.k = rb.j group by l.k order by l.k"),
    ("nulls", "select distinct rb.w from l left join rb on l.k = rb.j "
              "order by rb.w"),
    # tests/test_nulls3vl.py
    ("nulls3vl", "select f.k from f left join d on f.k = d.j "
                 "where d.m < 100"),
    ("nulls3vl", "select f.k from f left join d on f.k = d.j "
                 "where not (d.m < 100)"),
    ("nulls3vl", "select f.k from f left join d on f.k = d.j "
                 "where d.m < 100 or f.x = 40"),
    ("nulls3vl", "select f.k from f left join d on f.k = d.j "
                 "where not (d.m < 100 and f.x = 40)"),
    ("nulls3vl", _BIG_3VL.format("r.m > 0")),
    ("nulls3vl", _BIG_3VL.format("not (r.m > 0)")),
    ("nulls3vl", _BIG_3VL.format("r.m > 0 or l.x < 0")),
    ("nulls3vl", _BIG_3VL.format("r.m > 0 and l.x < 0")),
    ("nulls3vl", _BIG_3VL.format("not (r.m > 0 or l.x < 0)")),
    ("nulls3vl", _BIG_3VL.format("r.m + l.x > 10")),
    ("nulls3vl", _BIG_3VL.format("r.m between 0 and 50")),
    ("nulls3vl", _BIG_3VL.format("r.m in (1, 2, 3)")),
    ("nulls3vl", _BIG_3VL.format("r.m is null or r.m > 50")),
    ("nulls3vl", "select f.k, case when d.m > 6 then 1 when d.m <= 6 then 2 "
                 "else 9 end as c from f left join d on f.k = d.j "
                 "order by f.k, d.m"),
    ("nulls3vl", "select f.k, case when d.m > 0 then d.m else -1 end as c "
                 "from f left join d on f.k = d.j order by f.k, d.m"),
    ("nulls3vl", "select f.k, sum(d.m) as s, avg(d.m) as a, min(d.m) as mn, "
                 "max(d.m) as mx, count(d.m) as c from f "
                 "left join d on f.k = d.j group by f.k order by f.k"),
    ("nulls3vl", "select l.k, avg(r.m) as a from l left join r "
                 "on l.k = r.j group by l.k having avg(r.m) > 0 "
                 "order by l.k"),
    ("nulls3vl", "select f.k from f left join d on f.k = d.j "
                 "group by f.k having sum(d.m) is null order by f.k"),
    ("nulls3vl", "select f.k, coalesce(sum(d.m), -1) as s from f "
                 "left join d on f.k = d.j group by f.k order by f.k"),
    ("nulls3vl", "select f.k, sum(d.m) as s from f left join d "
                 "on f.k = d.j group by f.k order by s, f.k"),
    ("nulls3vl", "select f.k, sum(d.m) as s from f left join d "
                 "on f.k = d.j group by f.k order by s nulls first, f.k"),
    ("nulls3vl", "select nf.k, ne.w from nf left join nd on nf.k = nd.j "
                 "join ne on nd.m = ne.z order by nf.k"),
    ("nulls3vl", "select nf.k, ne.w from nf left join nd on nf.k = nd.j "
                 "left join ne on nd.m = ne.z order by nf.k"),
    ("nulls3vl", "select count(*) as n, count(ce.w) as c, sum(ce.w) as s "
                 "from cf left join cd on cf.k = cd.j "
                 "left join ce on cd.m = ce.z"),
    ("nulls3vl", "select l.k, sum(r.m) as s, avg(r.m) as a from l "
                 "left join r on l.k = r.j group by l.k "
                 "having avg(r.m) > -50 order by l.k"),
    ("nulls3vl", "select l.k, count(distinct r.m) as cd from l "
                 "left join r on l.k = r.j group by l.k order by l.k"),
    ("nulls3vl", "select sum(r.m) as s from l left join r on l.k = r.j "
                 "where r.m > 999"),
    ("nulls3vl", f"select qa.k, coalesce(qr.w, qr2.u) as x {_QBASE} "
                 f"order by qa.k"),
    ("nulls3vl", f"select qa.k {_QBASE} where coalesce(qr.w, qr2.u) = 10"),
    ("nulls3vl", f"select sum(coalesce(qr.w, qr2.u)) as s, "
                 f"count(coalesce(qr.w, qr2.u)) as n {_QBASE}"),
    ("nulls3vl", f"select coalesce(qr.w, qr2.u) as g, count(*) as n {_QBASE} "
                 f"group by coalesce(qr.w, qr2.u) order by g nulls last"),
    ("nulls3vl", "select ta.k, tr.w from ta left join tr on ta.k = tr.k "
                 "where ta.v + coalesce(tr.w, 0) < 50 order by tr.w asc "
                 "limit 2"),
    ("nulls3vl", "select da.k, dr.j, ds.w from da left join dr "
                 "on da.k = dr.k left join ds on dr.j = ds.j"),
]

_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        j = harkdb_tpu.Context()
        p = harkdb_tpu_torch.Context(device="cpu")
        for tname, df in SETS[name]().items():
            j.create_table(tname, df)
            p.create_table(tname, df)
        _CONTEXTS[name] = (j, p)
    return _CONTEXTS[name]


def _assert_same(a: np.ndarray, b: np.ndarray, query: str) -> None:
    assert a.shape == b.shape, (query, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, equal_nan=True,
                                   err_msg=query)
    else:
        np.testing.assert_array_equal(b, a, err_msg=query)
    assert a.dtype == b.dtype, (query, a.dtype, b.dtype)


PLAN_FIELDS = ("fast_agg", "fast_candidate", "last_fast_span", "_probed_fast")


@pytest.mark.parametrize("tables,query", CASES)
def test_join_query_matches_jax(tables, query):
    j, p = _contexts(tables)
    _assert_same(j.sql(query), p.sql(query), query)
    dj, dp = j.sql_df(query), p.sql_df(query)
    assert list(dj.columns) == list(dp.columns)
    for col in dj.columns:
        assert dj[col].isna().tolist() == dp[col].isna().tolist(), col
    pd.testing.assert_frame_equal(dp, dj, check_dtype=False, rtol=1e-6)
    pj, pp = j._plan(query), p._plan(query)
    for f in PLAN_FIELDS:
        assert getattr(pp, f) == getattr(pj, f), f
