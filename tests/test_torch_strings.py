"""harkdb_tpu_torch string columns vs harkdb_tpu, on the CPU.

The queries of tests/test_strings.py (all but ``TestStringDistributed``,
the mesh cases) and of tests/test_sql_ext.py ``TestStringFuncs`` and
``TestOnResidualsAndIlike`` run through ``harkdb_tpu.Context`` (JAX on the
CPU) and ``harkdb_tpu_torch.Context(device="cpu")`` over the same tables,
built from the same seeds as there: filters, LIKE / ILIKE, string GROUP BY
/ ORDER BY / MIN / MAX, joins over merged dictionaries, column-versus-column
comparisons, the string functions, ON residuals and the error cases. Each
query's raw matrix must be identical (integer codes bit for bit), its
``sql_df`` frame equal with None in the same places; each error case must
raise the same exception type with the same text.
"""

import numpy as np
import pandas as pd
import pytest

import harkdb_tpu
import harkdb_tpu_torch

from test_torch_derived import assert_error_same, assert_query_same, \
    make_pair

CITIES = ["oslo", "bergen", "tromso", "stavanger", "narvik", "alta"]


def _sctx():
    """tests/test_strings.py's ``sctx`` (the ``rng`` fixture: seed 0)."""
    rng = np.random.default_rng(0)
    n = 400
    return {"t": pd.DataFrame({
        "city": rng.choice(CITIES, n),
        "tag": rng.choice(["a", "b", "c"], n),
        "v": rng.integers(-50, 50, n).astype(np.int32),
    })}


def _sctx_n():
    """``sctx`` with the numeric join table of
    test_string_to_numeric_join_rejected."""
    return {**_sctx(), "n": {"k": [1, 2, 3]}}


def _lut():
    """test_scattered_match_lut_path: 300 words, 2000 rows (seed 0)."""
    rng = np.random.default_rng(0)
    words = [f"w{i:04d}{'x' if i % 3 == 0 else 'y'}" for i in range(300)]
    vals = rng.choice(words, 2000)
    return {"t": pd.DataFrame({"s": vals,
                               "v": np.arange(2000, dtype=np.int32)})}


def _joins():
    """TestStringJoins' tables: the different-dictionaries pair (seed 0),
    the merged-dictionary pair, the chained three and the pushdown pair."""
    rng = np.random.default_rng(0)
    return {
        "l": pd.DataFrame({
            "name": rng.choice(["ada", "bob", "cyd", "dan"], 100),
            "x": rng.integers(0, 100, 100).astype(np.int32),
        }),
        "r": pd.DataFrame({"who": ["bob", "dan", "eve"],
                           "y": np.array([7, 8, 9], dtype=np.int32)}),
        "ml": pd.DataFrame({"k": ["b", "a", "c"],
                            "x": np.arange(3, dtype=np.int32)}),
        "mr": pd.DataFrame({"k2": ["c", "b", "z"],
                            "y": np.arange(3, dtype=np.int32)}),
        "a": pd.DataFrame({"s": ["m", "n", "p"],
                           "x": np.arange(3, dtype=np.int32)}),
        "b": pd.DataFrame({"s2": ["n", "p", "q"],
                           "y": np.arange(3, dtype=np.int32)}),
        "d": pd.DataFrame({"s3": ["p", "n", "r"],
                           "z": np.arange(3, dtype=np.int32)}),
        "pl": pd.DataFrame({"k": ["b", "a", "c", "b"],
                            "x": np.arange(4, dtype=np.int32)}),
        "pr": pd.DataFrame({"k2": ["c", "b", "z"],
                            "y": np.arange(3, dtype=np.int32)}),
        # TestLeftJoinStringNull
        "nl": pd.DataFrame({"k": [1, 2], "x": np.array([10, 20], np.int32)}),
        "nr": pd.DataFrame({"k2": [1, 3], "tag": ["zulu", "alpha"]}),
    }


def _same_dict():
    """TestStringColVsCol.test_same_table_compare (seed 0)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        "a": rng.choice(["x", "y", "z"], 200),
        "b": rng.choice(["x", "y", "z"], 200),
        "v": np.arange(200, dtype=np.int32),
    })}


def _cross_dict():
    """TestStringColVsCol.test_cross_dict_compare_merges (seed 0)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        "a": rng.choice(["ant", "bee", "cat"], 150),
        "b": rng.choice(["bee", "cat", "dog"], 150),
        "v": np.arange(150, dtype=np.int32),
    })}


def _names():
    """tests/test_sql_ext.py's ``sctx`` (table p), the ILIKE table and
    ``tctx`` (t, r)."""
    return {
        "p": pd.DataFrame({
            "name": ["Alice", "bob", "CAROL", "dave", "alice", "Ann"],
            "v": np.arange(6, dtype=np.int32),
        }),
        "ip": pd.DataFrame({"name": ["Alice", "ALINE", "bob", "alf"]}),
        "t": pd.DataFrame({"k": np.array([1, 1, 2, 2, 3], np.int32),
                           "v": np.array([10, 20, 30, 40, 50], np.int32)}),
        "r": pd.DataFrame({"k": np.array([1, 1, 2], np.int32),
                           "w": np.array([5, 15, 100], np.int32)}),
    }


def _residual():
    """TestOnResidualsAndIlike.test_inner_on_residual (seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "a": pd.DataFrame({
            "u": rng.integers(0, 10, 200).astype(np.int32),
            "x": rng.integers(0, 50, 200).astype(np.int32)}),
        "b": pd.DataFrame({
            "p": rng.integers(0, 10, 100).astype(np.int32),
            "y": rng.integers(0, 50, 100).astype(np.int32)}),
    }


SETS = {
    "s": _sctx, "s_n": _sctx_n, "lut": _lut, "joins": _joins,
    "same": _same_dict, "cross": _cross_dict, "names": _names,
    "residual": _residual,
    "quote": lambda: {"q": {"s": ["it's", "plain"], "v": [1, 2]}},
}

_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        _CONTEXTS[name] = make_pair(SETS[name]())
    return _CONTEXTS[name]


CASES = [
    # TestStringFilters
    ("s", "select city, v from t where city = 'oslo'"),
    ("s", "select city from t where city = 'nowhere'"),
    ("s", "select city from t where city != 'nowhere'"),
    *[("s", f"select city, v from t where city {op} 'narvik'")
      for op in ("<", "<=", ">", ">=")],
    ("s", "select city from t where city < 'n'"),
    ("s", "select city from t where 'n' < city"),
    ("s", "select city, v from t where city in ('oslo', 'alta', 'zzz')"),
    ("s", "select city from t where city between 'b' and 'o'"),
    ("quote", "select v from q where s = 'it''s'"),
    # TestLike
    ("s", "select city from t where city like 'b%'"),
    ("s", "select city from t where city like '%o'"),
    ("s", "select city from t where city like '%av%'"),
    ("s", "select city from t where city like '_slo'"),
    ("s", "select city from t where city not like 'b%'"),
    ("lut", "select s, v from t where s like '%x'"),
    # TestStringGroupOrder
    ("s", "select city, sum(v) as s, count(*) as n from t group by city"),
    ("s", "select city, tag, count(*) as n from t group by city, tag"),
    ("s", "select city, v from t order by city desc, v"),
    ("s", "select min(city) as lo, max(city) as hi, "
          "count(distinct city) as d from t"),
    ("s", "select tag, count(distinct city) as d from t group by tag"),
    ("s", "select distinct city, tag from t"),
    ("s", "select sum(case when city = 'oslo' then v else 0 end) as s "
          "from t"),
    ("s", "select tag, max(city) as m from t group by tag "
          "having max(city) >= 'oslo'"),
    # TestStringJoins
    ("joins", "select l.name, l.x, r.y from l join r on l.name = r.who"),
    ("joins", "select ml.k, mr.k2 from ml join mr on ml.k = mr.k2"),
    ("joins", "select a.s, b.y, d.z from a join b on a.s = b.s2 "
              "join d on a.s = d.s3"),
    ("joins", "select pl.k, pl.x, pr.y from pl join pr on pl.k = pr.k2 "
              "where pl.k = 'b' order by pl.x"),
    # TestStringColVsCol
    ("same", "select v from t where a = b"),
    ("same", "select v from t where a < b"),
    ("cross", "select v from t where a = b"),
    ("cross", "select v from t where a >= b"),
    # TestStringErrors.test_literal_literal_folds
    ("s", "select count(*) as n from t where 'a' < 'b'"),
    ("s", "select count(*) as n from t where 'a' > 'b'"),
    # TestLeftJoinStringNull: unmatched string cells decode to None in
    # sql_df, the raw matrix keeps the 0-fill
    ("joins", "select nl.k, nr.tag from nl left join nr on nl.k = nr.k2 "
              "order by nl.k"),
    # tests/test_sql_ext.py TestStringFuncs
    ("names", "select name, upper(name) as u, lower(name) as l, "
              "length(name) as n, substr(name, 1, 2) as s2 from p "
              "order by v"),
    ("names", "select name from p where upper(name) = 'ALICE' order by v"),
    ("names", "select name from p where length(name) = 3"),
    ("names", "select name from p where lower(name) like 'a%' order by v"),
    ("names", "select upper(substr(name, 2, 2)) as m from p order by v"),
    ("names", "select upper(name) as u, count(*) as n, sum(v) as s from p "
              "group by upper(name) order by u"),
    ("names", "select min(lower(name)) as mn, max(upper(name)) as mx "
              "from p"),
    ("names", "select name from p order by lower(name), v"),
    # TestOnResidualsAndIlike
    ("residual", "select a.u, a.x, b.y from a join b "
                 "on a.u = b.p and a.x < b.y and b.y - a.x != 7 "
                 "order by a.u, a.x, b.y"),
    ("names", "select name from ip where name ilike 'al%'"),
    ("names", "select name from ip where name not ilike '%F'"),
]


@pytest.mark.parametrize("tables,query", CASES)
def test_string_query_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_query_same(j, p, query)


ERRORS = [
    # TestLike
    ("s", "select v from t where v like '1%'"),
    ("s", "select v from t where city like city"),
    # TestStringJoins.test_string_to_numeric_join_rejected
    ("s_n", "select * from t join n on t.city = n.k"),
    # TestStringErrors
    ("s", "select city + 1 from t"),
    ("s", "select v + city from t"),
    ("s", "select -city from t"),
    ("s", "select abs(city) from t"),
    ("s", "select sum(city) from t"),
    ("s", "select avg(city) from t"),
    ("s", "select prod(city) from t"),
    ("s", "select v from t where city = 1"),
    ("s", "select v from t where v = 'oslo'"),
    ("s", "select 'hello' from t"),
    ("s", "select case when v > 0 then city else city end from t"),
    # tests/test_sql_ext.py TestStringFuncs
    ("names", "select upper(v) from p"),
    ("names", "select length(v) from p"),
    ("names", "select substr(name, 0, 2) from p"),
    # TestOnResidualsAndIlike.test_outer_residual_rejected
    ("names", "select * from t left join r on t.k = r.k and t.v < r.w"),
]


@pytest.mark.parametrize("tables,query", ERRORS)
def test_string_error_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_error_same(j, p, query)


def test_save_load_keeps_dictionaries(tmp_path):
    """TestStringPersistence.test_save_load_roundtrip: each package's save
    directory loads back into the same answers (and each loads the
    other's)."""
    j, p = make_pair(_sctx())
    q = "select city, sum(v) as s from t group by city"
    j.save(str(tmp_path / "jax"))
    p.save(str(tmp_path / "torch"))
    for src in ("jax", "torch"):
        j2, p2 = harkdb_tpu.Context(), harkdb_tpu_torch.Context(device="cpu")
        j2.load(str(tmp_path / src))
        p2.load(str(tmp_path / src))
        assert_query_same(j2, p2, q)
        pd.testing.assert_frame_equal(p2.sql_df(q), p.sql_df(q))


def test_csv_ingest_strings(tmp_path):
    """TestStringPersistence.test_csv_ingest_strings: a CSV with a text
    column goes through pandas and dictionary-encodes."""
    path = tmp_path / "s.csv"
    path.write_text("name,score\nzoe,3\nabe,1\nzoe,5\n")
    j, p = make_pair({"s": str(path)})
    assert_query_same(j, p, "select name, sum(score) as t from s "
                            "group by name")
    assert p.tables["s"].dicts["name"].tolist() == ["abe", "zoe"]
