"""harkdb_tpu_torch on tests/test_fuzz.py's mesh fuzzers vs harkdb_tpu's
mesh, on the CPU.

``test_fuzz_distributed_matches_single`` (the distributed tail: range-
partitioned ORDER BY, sharded LIMIT / OFFSET and DISTINCT, COUNT(DISTINCT),
a join), ``test_fuzz_3vl_distributed_parity`` (NULL predicates over a LEFT
JOIN, NULL-skipping aggregates, a FULL OUTER JOIN of two derived tables)
and the mesh branch of ``test_fuzz_strings`` (string predicates and string
group keys, even seeds), with the same seeds, tables and queries; the
generators are test_fuzz.py's own. The port runs in a pool of 4 gloo ranks
(``torch_mesh_pool``); every rank must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``: the raw matrix where
test_fuzz.py compares ``sql``, the ``sql_df`` frame where it compares
frames (NULLs in the same places; the ``avg`` columns within rtol 1e-6).
"""

import numpy as np
import pandas as pd
import pytest

from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from test_fuzz import _NULLABLE_PREDS, _PREDS, _SPREDS, _WORDS, _make_tables
from torch_mesh_pool import assert_same, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def check(pool, jmesh, tables, queries, frames):
    expect = jax_sql(jmesh, tables, queries, frames=frames)
    assert all(e[0] == "ok" for e in expect), expect
    assert_same(expect, pool.run("run_sql", tables, queries, None, frames),
                queries)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_distributed_matches_jax(pool, jmesh, seed):
    rng = np.random.default_rng(5000 + seed)
    t1, t2 = _make_tables(rng, int(rng.integers(50, 400)))
    sql_pred, _ = _PREDS[seed % len(_PREDS)]
    queries = [
        f"select a, b, c from t1 where {sql_pred} order by b desc, c "
        f"limit {5 + seed * 3} offset {seed}",
        f"select distinct a, b from t1 where {sql_pred} order by a",
        "select a, count(distinct c), sum(b) from t1 group by a order by a",
        f"select a, c, w from t1 join t2 on t1.a = t2.j where {sql_pred} "
        "order by w, c limit 40",
    ]
    check(pool, jmesh, {"t1": t1, "t2": t2},
          [queries[seed % len(queries)]], frames=False)


@pytest.mark.parametrize("seed", range(0, 8, 2))
def test_fuzz_strings_mesh_branch(pool, jmesh, seed):
    rng = np.random.default_rng(6000 + seed)
    n = int(rng.integers(1, 300))
    t1 = pd.DataFrame({
        "s": rng.choice(_WORDS, n),
        "b": rng.integers(-8, 9, n).astype(np.int32),
        "c": rng.integers(0, 50, n).astype(np.int32),
    })
    sql_pred, _ = _SPREDS[seed % len(_SPREDS)]
    check(pool, jmesh, {"t1": t1}, [
        f"select s, sum(c), count(distinct b), min(s), max(b) from t1 "
        f"where {sql_pred} group by s order by s"], frames=True)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_3vl_distributed_parity(pool, jmesh, seed):
    rng = np.random.default_rng(7300 + seed)
    n = int(rng.integers(50, 400))
    t1 = pd.DataFrame({
        "a": rng.integers(0, 14, n).astype(np.int32),
        "b": rng.integers(-8, 9, n).astype(np.int32),
    })
    t2 = pd.DataFrame({
        "j": rng.permutation(8).astype(np.int32),
        "w": rng.integers(-5, 20, 8).astype(np.int32),
    })
    sql_pred, _ = _NULLABLE_PREDS[seed % len(_NULLABLE_PREDS)]
    check(pool, jmesh, {"l": t1, "r": t2}, [
        f"select l.a, l.b, r.w from l left join r on l.a = r.j "
        f"where {sql_pred} order by l.a, l.b, r.w",
        "select l.a, sum(r.w) as s, avg(r.w) as av from l "
        "left join r on l.a = r.j group by l.a "
        "having count(*) > 1 order by l.a",
        "select a.u, b.w from (select a as u from l where b > 0) a "
        "full outer join (select j, w from r where w > 2) b "
        "on a.u = b.j order by a.u nulls last, b.w nulls last",
    ], frames=True)
