"""harkdb_tpu_torch COUNT(DISTINCT), LEFT JOIN, metrics, persistence,
OFFSET, integer division, the safety subsystems and columnar storage vs
harkdb_tpu, on the CPU.

The queries of tests/test_count_distinct.py (its two mesh tests left out)
and tests/test_features.py (its mesh test
``TestLeftJoin.test_distributed_matches`` left out) run through
``harkdb_tpu.Context`` (JAX on the CPU) and
``harkdb_tpu_torch.Context(device="cpu")`` over the same tables, built from
the same seeds as there; raw matrices must be identical (integers bit for
bit, float32 within rtol=1e-6, atol=0) and ``sql_df`` frames equal. The
metrics, persistence, ``debug_checks`` / ``debug_validate`` and retry cases
run on the port's own objects and are held to the JAX package's answers
and error texts.

tests/test_columnar.py's cases run against the port's ``columnar/``
(ingest dispatch, the ``Table`` surface and padding, ``ColumnBatch``).
Its JAX pytree case (a batch passed through ``jax.jit`` as one value) has
no torch counterpart; ``test_batch_passes_through_an_operator`` takes its
place: a batch goes through ``compact_batch`` as one value, and comes out
with the JAX package's names, rows and a 0-d int32 count.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.columnar.batch import ColumnBatch as JaxBatch
from harkdb_tpu.columnar.ingest import load_table as jax_load_table
from harkdb_tpu.prims.compaction import compact_batch as jax_compact_batch
from harkdb_tpu.sql.parser import parse_sql as jax_parse_sql
from harkdb_tpu.utils.checks import InvariantViolation as JaxViolation
from harkdb_tpu.utils.checks import debug_validate as jax_debug_validate
from harkdb_tpu_torch.columnar.batch import ColumnBatch, align_capacity
from harkdb_tpu_torch.columnar.ingest import load_table
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.config import EngineConfig
from harkdb_tpu_torch.prims.compaction import compact_batch
from harkdb_tpu_torch.sql.parser import parse_sql
from harkdb_tpu_torch.utils.checks import InvariantViolation, debug_validate

from test_torch_derived import assert_query_same, make_pair

CFG = EngineConfig()
DATA_CSV = os.path.join(os.path.dirname(__file__), "data", "data.csv")


def _rng_table(*cols):
    """One table drawn from a fresh seed-0 generator, as the ``rng``
    fixture gives each test: ``cols`` are (name, low, high, n)."""
    rng = np.random.default_rng(0)
    return {"t": pd.DataFrame({
        name: rng.integers(lo, hi, n).astype(np.int32)
        for name, lo, hi, n in cols})}


def _join_ctx():
    """tests/test_features.py's ``join_ctx`` (pandas int64 columns)."""
    return {"l": pd.DataFrame({"k": [1, 2, 3, 5], "a": [10, 20, 30, 50]}),
            "r": pd.DataFrame({"k2": [2, 3, 3, 4],
                               "b": [200, 300, 301, 400]})}


def _left_vs_pandas():
    """TestLeftJoin.test_vs_pandas (seed 0)."""
    rng = np.random.default_rng(0)
    nl, nr = 200, 100
    return {"l": pd.DataFrame({"k": rng.integers(0, 50, nl).astype(np.int32),
                               "a": np.arange(nl, dtype=np.int32)}),
            "r": pd.DataFrame({"j": rng.integers(0, 50, nr).astype(np.int32),
                               "b": np.arange(nr, dtype=np.int32)})}


def _float_agg():
    """TestMoreAggregates.test_float_aggregation (seed 0)."""
    rng = np.random.default_rng(0)
    return {"f": pd.DataFrame({
        "k": rng.integers(0, 5, 200).astype(np.int32),
        "x": rng.random(200).astype(np.float32) * 10,
    })}


def _division():
    """TestIntDivisionByZero's tables (the random one: seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "t": pd.DataFrame({"a": np.array([10, -7, 9, 5], np.int32),
                           "b": np.array([2, 0, 0, -2], np.int32)}),
        "r": pd.DataFrame({
            "a": rng.integers(-100, 100, 100).astype(np.int32),
            "b": rng.integers(-5, 6, 100).astype(np.int32)}),
        "x": pd.DataFrame({"x": np.array([1.0, -1.0, 0.0], np.float32)}),
    }


SETS = {
    # tests/test_count_distinct.py
    "verdict": lambda: {"t": pd.DataFrame({
        "k": np.array([1, 1, 1, 2, 2], np.int32),
        "v": np.array([5, 5, 7, 9, 9], np.int32)})},
    "grouped": lambda: _rng_table(("k", 0, 9, 800), ("v", 0, 25, 800),
                                  ("w", -40, 40, 800)),
    "ungrouped": lambda: _rng_table(("v", 0, 30, 500)),
    "where": lambda: _rng_table(("k", 0, 8, 600), ("v", 0, 15, 600)),
    "multi": lambda: _rng_table(("k", 0, 6, 400), ("a", 0, 7, 400),
                                ("b", 0, 50, 400)),
    "gkey": lambda: _rng_table(("k", 0, 5, 100)),
    "header": lambda: {"t": pd.DataFrame({"k": np.array([1], np.int32),
                                          "v": np.array([2], np.int32)})},
    # tests/test_features.py
    "join": _join_ctx,
    "left": _left_vs_pandas,
    "fagg": _float_agg,
    "oagg": lambda: _rng_table(("k", 0, 8, 300), ("v", 1, 100, 300)),
    "off": lambda: _rng_table(("k", 0, 1000, 300), ("v", 0, 9, 300)),
    "offa": lambda: {"t": pd.DataFrame({"a": np.arange(50, dtype=np.int32)}),
                     "s": pd.DataFrame({"a": np.arange(5, dtype=np.int32)})},
    "offg": lambda: _rng_table(("k", 0, 20, 400), ("v", 0, 9, 400)),
    "div": _division,
}

_CONTEXTS = {}


def _contexts(name):
    if name not in _CONTEXTS:
        _CONTEXTS[name] = make_pair(SETS[name]())
    return _CONTEXTS[name]


CASES = [
    # tests/test_count_distinct.py
    ("verdict", "select k, count(distinct v) from t group by k"),
    ("grouped", "select k, count(distinct v), sum(w), count(*) from t "
                "group by k"),
    ("ungrouped", "select count(distinct v) from t"),
    ("where", "select k, count(distinct v) as nd from t where v > 3 "
              "group by k having count(distinct v) > 5 order by k"),
    ("multi", "select k, count(distinct a), count(distinct b) from t "
              "group by k"),
    ("gkey", "select k, count(distinct k) from t group by k"),
    ("header", "select k, count(distinct v) from t group by k"),
    # tests/test_features.py TestLeftJoin
    ("join", "select k, a, b from l left join r on l.k = r.k2 "
             "order by k, b"),
    ("join", "select count(*) from l left join r on l.k = r.k2"),
    ("left", "select k, a, b from l left join r on l.k = r.j "
             "order by k, a, b"),
    # TestMoreAggregates
    ("fagg", "select k, sum(x), min(x), max(x) from f group by k"),
    ("oagg", "select k, sum(v) from t group by k order by sum(v) desc"),
    # TestOffset
    ("off", "select k from t order by k limit 10 offset 5"),
    ("offa", "select a from t offset 47"),
    ("offa", "select a from s offset 99"),
    ("offg", "select k, sum(v) from t group by k order by k "
             "limit 5 offset 3"),
    # TestIntDivisionByZero
    ("div", "select a / b, a % b from t"),
    ("div", "select a / b from r where b != 0"),
    ("div", "select x / 0.0 from x"),
]


@pytest.mark.parametrize("tables,query", CASES)
def test_feature_query_matches_jax(tables, query):
    j, p = _contexts(tables)
    assert_query_same(j, p, query)


@pytest.mark.parametrize("sql", ["select sum(distinct v) from t",
                                 "select count(distinct *) from t"])
def test_distinct_only_count(sql):
    """test_distinct_only_count: the parser's error, same type and text."""
    with pytest.raises(Exception) as ej:
        jax_parse_sql(sql)
    with pytest.raises(Exception) as ep:
        parse_sql(sql)
    assert type(ep.value).__name__ == type(ej.value).__name__ == "SqlError"
    assert str(ep.value) == str(ej.value)


def test_explain_shows_offset():
    j, p = _contexts("offa")
    q = "select a from s limit 1 offset 2"
    assert p.explain(q) == j.explain(q)
    assert "Offset 2" in p.explain(q)


def test_metrics_match_jax():
    """TestMetrics: rows out, timings and the plan-cache flag; the port's
    record has the JAX package's fields and eight of its own (the inner
    plans a query ran, the rows and row bits it sorted, the rows of its
    joins' count phases and those the kernels ran, the rows into its
    windows and set operations, the bytes it left on the card)."""
    j, p = make_pair(_join_ctx())
    for c in (j, p):
        out = c.sql("select k from l where k > 1")
        m = c.last_metrics
        assert m.rows_out == out.shape[0] == 3
        assert m.execute_ms > 0 and not m.distributed
        assert not m.cached_plan
        c.sql("select k from l where k > 1")
        assert c.last_metrics.cached_plan
    assert sorted(json.loads(p.last_metrics.to_json())) == sorted(
        [*json.loads(j.last_metrics.to_json()), "inner_plans_run",
         "sort_rows", "sort_row_bits", "join_rows", "join_fused_rows",
         "window_rows", "setop_rows", "held_bytes"])


def test_save_load_roundtrip(tmp_path):
    """TestPersistence: the port's save loads back; so does the JAX
    package's; float columns keep their values."""
    j, p = make_pair(_join_ctx())
    q = "select k, a from l order by k"
    p.save(str(tmp_path / "torch"))
    j.save(str(tmp_path / "jax"))
    for src in ("torch", "jax"):
        p2 = harkdb_tpu_torch.Context(device="cpu")
        p2.load(str(tmp_path / src))
        assert set(p2.tables) == {"l", "r"}
        np.testing.assert_array_equal(p2.sql(q), j.sql(q))
    j, p = make_pair({"f": pd.DataFrame({"x": [1.5, 2.5], "i": [1, 2]})})
    p.save(str(tmp_path / "f"))
    p2 = harkdb_tpu_torch.Context(device="cpu")
    p2.load(str(tmp_path / "f"))
    out = p2.sql("select x, i from f")
    np.testing.assert_array_equal(out, j.sql("select x, i from f"))
    np.testing.assert_allclose(out, [[1.5, 1.0], [2.5, 2.0]])


def test_debug_checks_pass():
    """TestSafetySubsystems.test_debug_checks_pass, both packages."""
    j = harkdb_tpu.Context(harkdb_tpu.EngineConfig(debug_checks=True))
    p = harkdb_tpu_torch.Context(EngineConfig(debug_checks=True),
                                 device="cpu")
    for c in (j, p):
        c.create_table("t", pd.DataFrame({"a": [1, 2, 3]}))
    assert_query_same(j, p, "select a from t where a > 1")
    np.testing.assert_array_equal(p.sql("select a from t where a > 1"),
                                  [[2], [3]])


def test_debug_checks_run_at_both_call_sites(monkeypatch):
    """``debug_checks`` validates the input of phase B and the batch after
    the WHERE compaction (the JAX package's two call sites); off, it
    validates nothing."""
    from harkdb_tpu_torch.plan import planner

    seen = []

    def record(batch, where=""):
        seen.append(where)
        return debug_validate(batch, where)

    monkeypatch.setattr(planner, "debug_validate", record)
    tables = {"t": {"k": np.int32([1, 2, 3]), "v": np.int32([5, 1, 9])},
              "r": {"k": np.int32([1, 2, 3]), "w": np.int32([6, 0, 1])}}
    q = "select t.k, r.w from t join r on t.k = r.k where t.v < r.w"
    for cfg, want in ((EngineConfig(debug_checks=True),
                       ["phase_b input", "after WHERE"]),
                      (EngineConfig(), [])):
        p = harkdb_tpu_torch.Context(cfg, device="cpu")
        for name, src in tables.items():
            p.create_table(name, src)
        seen.clear()
        assert p.sql(q).tolist() == [[1, 6]]
        assert seen == want


def test_debug_validate_catches_bad_batch():
    """TestSafetySubsystems.test_debug_validate_catches_bad_batch: the
    same violations raise with the JAX package's text."""
    cases = [
        ({"a": np.zeros(4, np.int32)}, 9, "test"),
        ({"a": np.zeros(4, np.int32)}, -1, "neg"),
        ({"a": np.zeros(4, np.int32), "b": np.zeros(8, np.int32)}, 2, "cap"),
    ]
    for cols, n, where in cases:
        with pytest.raises(JaxViolation) as ej:
            jax_debug_validate(JaxBatch(
                {k: jnp.asarray(v) for k, v in cols.items()}, jnp.int32(n)),
                where)
        bad = ColumnBatch({k: torch.from_numpy(v) for k, v in cols.items()},
                          torch.tensor(n, dtype=torch.int32))
        with pytest.raises(InvariantViolation) as ep:
            debug_validate(bad, where)
        assert str(ep.value) == str(ej.value)
        assert isinstance(ep.value, AssertionError)
    good = ColumnBatch({"a": torch.zeros(4, dtype=torch.int32)},
                       torch.tensor(4, dtype=torch.int32))
    assert debug_validate(good, "ok") is good


def test_retry_on_transient_failure(monkeypatch):
    c = harkdb_tpu_torch.Context(device="cpu")
    c.create_table("t", pd.DataFrame({"a": [1, 2, 3]}))
    plan = c._plan("select a from t")
    calls = {"n": 0}
    real = plan.execute

    def flaky(tables):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated transient device failure")
        return real(tables)

    monkeypatch.setattr(plan, "execute", flaky)
    out = c.sql("select a from t")
    assert calls["n"] == 2
    np.testing.assert_array_equal(out, [[1], [2], [3]])


def test_retry_disabled_raises(monkeypatch):
    c = harkdb_tpu_torch.Context(EngineConfig(retry_on_failure=False),
                                 device="cpu")
    c.create_table("t", pd.DataFrame({"a": [1]}))
    plan = c._plan("select a from t")

    def boom(tables):
        raise RuntimeError("permanent")

    monkeypatch.setattr(plan, "execute", boom)
    with pytest.raises(RuntimeError, match="permanent"):
        c.sql("select a from t")


# -- tests/test_columnar.py against the port's columnar/ ----------------------

INGEST = {
    "dataframe": lambda: pd.DataFrame({"a": [1, 2, 3], "b": [4.0, 5.0, 6.0]}),
    "ndarray": lambda: np.arange(12).reshape(4, 3),
    "csv": lambda: DATA_CSV,
    "dict": lambda: {"x": [1, 2], "y": [3.5, 4.5]},
}


@pytest.mark.parametrize("source", sorted(INGEST))
def test_ingest_matches_jax(source):
    """TestIngest: the same headers, dtypes and values from each source."""
    cols, headers, dicts = load_table(INGEST[source](), CFG)
    jcols, jheaders, jdicts = jax_load_table(INGEST[source](),
                                             harkdb_tpu.EngineConfig())
    assert headers == jheaders and dicts == jdicts == {}
    for h in headers:
        assert cols[h].dtype == jcols[h].dtype
        np.testing.assert_array_equal(cols[h], jcols[h])
    want = {"dataframe": ["a", "b"], "ndarray": ["col1", "col2", "col3"],
            "csv": [f"col{i}" for i in range(1, 9)], "dict": ["x", "y"]}
    assert headers == want[source]


@pytest.mark.parametrize("source,text", [("foo.xlsx", "do not support loading"),
                                         (42, "not in a file")])
def test_ingest_errors_match_jax(source, text):
    """TestIngest.test_bad_file_type / test_bad_source_type."""
    with pytest.raises(Exception) as ej:
        jax_load_table(source, harkdb_tpu.EngineConfig())
    with pytest.raises(Exception) as ep:
        load_table(source, CFG)
    assert type(ep.value) is type(ej.value)
    assert str(ep.value) == str(ej.value)
    assert text in str(ep.value)


def test_table_surface():
    """TestTable.test_surface: get_name / get_schema / get_data."""
    t = Table("t", DATA_CSV, CFG, device="cpu")
    jt = harkdb_tpu.Table("t", DATA_CSV, harkdb_tpu.EngineConfig())
    assert t.get_name() == jt.get_name() == "t"
    assert t.get_schema() == jt.get_schema()
    data = t.get_data()
    assert data.shape == (7, 8)
    np.testing.assert_array_equal(data, jt.get_data())
    np.testing.assert_array_equal(data[6], [1, 2, 3, 4, 5, 3, 2, 1])


def test_table_padding():
    """TestTable.test_padding."""
    t = Table("t", np.ones((10, 2), np.int32), CFG, device="cpu")
    assert t.n_rows == 10
    assert t.capacity == CFG.row_align
    assert t.batch().capacity == CFG.row_align
    assert int(t.batch().n_valid) == 10
    assert t.batch().n_valid.dtype == torch.int32


def test_column_batch_roundtrip_and_padding():
    """TestColumnBatch.test_roundtrip and test_valid_mask: the live rows
    come back; the rows below n_valid are exactly the JAX batch's valid
    mask, and padding rows are zero."""
    b = ColumnBatch.from_numpy({"a": np.array([1, 2, 3], np.int32)},
                               capacity=8, device="cpu")
    assert b.capacity == 8
    mat, names = b.to_numpy()
    assert names == ["a"]
    np.testing.assert_array_equal(mat[:, 0], [1, 2, 3])
    b = ColumnBatch.from_numpy({"a": np.ones(3, np.int32)}, capacity=6,
                               device="cpu")
    jb = JaxBatch.from_numpy({"a": np.ones(3, np.int32)}, capacity=6)
    live = torch.arange(b.capacity) < b.n_valid
    np.testing.assert_array_equal(live.numpy(), np.asarray(jb.valid_mask()))
    assert b.column("a")[3:].tolist() == [0, 0, 0]


def test_batch_passes_through_an_operator():
    """In place of test_columnar.py's pytree case: a batch goes through an
    operator as one value and keeps its names, rows and a 0-d int32
    count on its device, as the JAX package's batch does through jit."""
    a = np.arange(10, dtype=np.int32)
    f = (np.arange(10) * 0.5).astype(np.float32)
    mask = a % 3 == 0
    b = ColumnBatch.from_numpy({"a": a, "f": f}, capacity=16, device="cpu")
    jb = JaxBatch.from_numpy({"a": a, "f": f}, capacity=16)
    out = compact_batch(b, torch.from_numpy(np.r_[mask, np.zeros(6, bool)]))
    jout = jax_compact_batch(jb, jnp.asarray(np.r_[mask, np.zeros(6, bool)]))
    assert isinstance(out, ColumnBatch) and out.names == jout.names
    assert out.n_valid.shape == () and out.n_valid.dtype == torch.int32
    assert out.device == b.device
    np.testing.assert_array_equal(out.to_numpy()[0], jout.to_numpy()[0])


def test_align_capacity():
    from harkdb_tpu.columnar.batch import align_capacity as jax_align

    for n in (0, 1, 1024, 1025):
        assert align_capacity(n, 1024) == jax_align(n, 1024)
    assert [align_capacity(n, 1024) for n in (0, 1, 1024, 1025)] == [
        1024, 1024, 1024, 2048]
