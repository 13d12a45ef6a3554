"""harkdb_tpu_torch's distributed joins vs harkdb_tpu's, on the CPU: every
join kind and the outer joins' NULLs over the mesh.

The mesh cases of tests/test_joins_ext.py (``TestDistributedParity``:
multi-key inner and LEFT, RIGHT, multi-key FULL OUTER, CROSS, a grouped
LEFT JOIN) and tests/test_nulls.py (``test_distributed_parity`` and the
``QUERIES`` of ``test_matches_single_chip``: NULL ordering, IS NULL,
NULL-skipping aggregates and DISTINCT over a LEFT JOIN), decoded by
``sql_df``. The port runs in a pool of 4 gloo ranks
(``torch_mesh_pool``); every rank's frame must equal
``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s, NULLs in the same
places.
"""

import numpy as np
import pandas as pd
import pytest

from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from torch_mesh_pool import assert_same, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def check(pool, jmesh, tables, queries):
    expect = jax_sql(jmesh, tables, queries, frames=True)
    assert_same(expect, pool.run("run_sql", tables, queries, None, True),
                queries)


def _two():
    rng = np.random.default_rng(0)
    nl, nr = 300, 180
    a = pd.DataFrame({"u": rng.integers(0, 12, nl).astype(np.int32),
                      "v": rng.integers(0, 6, nl).astype(np.int32),
                      "val": rng.integers(-50, 50, nl).astype(np.int32)})
    b = pd.DataFrame({"p": rng.integers(0, 12, nr).astype(np.int32),
                      "q": rng.integers(0, 8, nr).astype(np.int32),
                      "w": rng.integers(0, 100, nr).astype(np.int32)})
    return {"a": a, "b": b}


JOIN_KINDS = {
    "inner_multi_key": "select a.u, a.v, a.val, b.w from a "
                       "join b on a.u = b.p and a.v = b.q "
                       "order by a.u, a.v, a.val, b.w",
    "left_multi_key": "select a.u, a.v, b.w from a "
                      "left join b on a.u = b.p and a.v = b.q "
                      "order by a.u, a.v, b.w nulls last",
    "right": "select a.u, a.val, b.w from a right join b on a.u = b.p "
             "order by b.p, b.w, a.val nulls last",
    "full_outer_multi_key": "select a.u, a.val, b.w from a "
                            "full outer join b on a.u = b.p and a.v = b.q "
                            "order by a.u nulls last, a.val, "
                            "b.w nulls last",
    "cross": "select count(*) as n, sum(a.val) as s from a cross join b",
    "grouped_left": "select a.u, count(b.w) as c, sum(b.w) as s from a "
                    "left join b on a.u = b.p and a.v = b.q "
                    "group by a.u order by a.u",
    # the tail's join restore chain with no ORDER BY: keys, outer-join
    # flags and row ids give the single-device order
    "right_unordered": "select a.u, a.val, b.w from a right join b "
                       "on a.u = b.p",
    "full_unordered": "select a.u, a.val, b.w from a full outer join b "
                      "on a.u = b.p and a.v = b.q",
}


@pytest.mark.parametrize("name", list(JOIN_KINDS))
def test_join_kind(pool, jmesh, name):
    check(pool, jmesh, _two(), [JOIN_KINDS[name]])


def _big():
    rng = np.random.default_rng(0)
    nl, nr = 400, 150
    l_ = pd.DataFrame({"k": rng.integers(0, 60, nl).astype(np.int32),
                       "v": rng.integers(-30, 30, nl).astype(np.int32)})
    r = pd.DataFrame({"j": rng.integers(0, 40, nr).astype(np.int32),
                      "w": rng.integers(1, 100, nr).astype(np.int32)})
    return {"l": l_, "r": r}


NULL_QUERIES = [
    "select l.k, l.v, r.w from l left join r on l.k = r.j "
    "order by r.w, l.k, l.v limit 60",
    "select l.k, l.v, r.w from l left join r on l.k = r.j "
    "order by r.w desc nulls last, l.k, l.v limit 60",
    "select distinct r.w from l left join r on l.k = r.j "
    "order by r.w nulls first",
    "select l.k, r.w, r.w is null as m from l left join r on l.k = r.j "
    "order by l.k, l.v, r.w",
    "select l.k from l left join r on l.k = r.j where r.w is null "
    "order by l.k, l.v",
    "select l.k, count(r.w) as c, sum(r.w) as s, min(r.w) as mn "
    "from l left join r on l.k = r.j group by l.k order by l.k",
    "select distinct r.w from l left join r on l.k = r.j order by r.w",
]


@pytest.mark.parametrize("qi", range(len(NULL_QUERIES)))
def test_left_join_nulls(pool, jmesh, qi):
    check(pool, jmesh, _big(), [NULL_QUERIES[qi]])
