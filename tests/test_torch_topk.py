"""The ORDER BY + small LIMIT top-k path of harkdb_tpu_torch vs harkdb_tpu,
on the CPU.

For one ORDER BY key that is an int of up to 4 bytes or a float32, with
``limit + offset <= 1024``, no DISTINCT and no presorted order, both
packages select rows by top-k over a view of the key by its IEEE bits
(JAX's ``_route_order_view``, the port's ``ops.sort.ieee_order_view``)
instead of sorting (``harkdb_tpu/plan/planner.py:2053-2111``). The view
orders floats by their IEEE bits: a NaN with its sign bit set ranks below
-inf, and a positive NaN above +inf under DESC too, where the full sort
puts every NaN last. So the gate decides which rows come back, and the
port must take it exactly where JAX does.

Every query runs through ``harkdb_tpu.Context`` and
``harkdb_tpu_torch.Context(device="cpu")`` on the same seeded numpy
tables, and a spy on the planner's ``top_k_indices`` counts the
selections. Tolerance: exact (every key is an integer or compared by its
bits; float results are compared by their bit patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.parallel.dist_ops import _route_order_view as jax_view
from harkdb_tpu_torch.columnar.table import Table
from harkdb_tpu_torch.ops.sort import ieee_order_view
from harkdb_tpu_torch.ops.topk import top_k_indices, top_k_indices_reference
from harkdb_tpu_torch.plan import planner
from torch_topk_cases import (
    I32_MAX, I32_MIN, QUERIES, assert_same, special_floats, tables,
)


@pytest.fixture(scope="module")
def contexts():
    j = harkdb_tpu.Context()
    p = harkdb_tpu_torch.Context(device="cpu")
    for name, src in tables().items():
        j.create_table(name, src)
        p.create_table(name, src)
    return j, p


@pytest.fixture
def spy(monkeypatch):
    """Counts the planner's top-k selections."""
    calls = []

    def counted(view, k):
        calls.append(k)
        return top_k_indices(view, k)

    monkeypatch.setattr(planner, "top_k_indices", counted)
    return calls


@pytest.mark.parametrize("query,topk", QUERIES, ids=[q for q, _ in QUERIES])
def test_rows_match_jax(contexts, spy, query, topk):
    j, p = contexts
    want = j.sql(query)
    got = p.sql(query)
    assert_same(want, got, query)
    assert len(spy) == int(topk), (query, spy)


NULL_QUERIES = [
    "select a.k, r.w from a left join r on a.k = r.k order by r.w limit 8",
    "select a.k, r.w from a left join r on a.k = r.k "
    "order by r.w nulls first limit 8",
    "select a.k, r.w from a left join r on a.k = r.k "
    "order by r.w desc limit 8",
    "select a.k, r.w from a left join r on a.k = r.k "
    "order by r.w desc nulls last limit 30 offset 2",
    "select a.k, r.w from a left join r on a.k = r.k "
    "where a.v + coalesce(r.w, 0) < 50 order by r.w limit 6",
]


@pytest.mark.parametrize("query", NULL_QUERIES)
def test_nullable_key_matches_jax(contexts, spy, query):
    """A key made nullable by a LEFT JOIN: the NULL end is folded into the
    key before the view, so NULLS FIRST / LAST hold on the top-k path."""
    j, p = contexts
    assert_same(j.sql(query), p.sql(query), query)
    want, got = j.sql_df(query), p.sql_df(query)
    pd.testing.assert_frame_equal(got.isna(), want.isna())
    assert len(spy) == 2                        # once for sql, once for sql_df


def test_float64_key_takes_the_sort(spy):
    """A float64 key would lose bits in the float32 view, so it takes the
    sort (every NaN last). The JAX package's ingest stores float64 as
    float32, so the port's table is built from host columns and held
    against a numpy stable sort."""
    rng = np.random.default_rng(4)
    f = rng.normal(0, 1, 500)
    f[[3, 40, 41]] = np.nan
    f[40] = -f[3]
    f[[7, 8]] = [1e-300, -1e-300]               # equal as float32
    k = np.arange(500, dtype=np.int32)
    p = harkdb_tpu_torch.Context(device="cpu")
    p.tables["d"] = Table.from_host("d", {"k": k, "f": f}, ["k", "f"], {},
                                    p.config, "cpu")
    got = p.sql("select k, f from d order by f limit 12")
    order = np.argsort(f, kind="stable")[:12]
    np.testing.assert_array_equal(got[:, 0], k[order])
    np.testing.assert_array_equal(got[:, 1].view(np.uint64),
                                  f[order].view(np.uint64))
    assert spy == []


def test_int8_key_takes_the_top_k(contexts, spy):
    """A key of 1 byte takes the top-k (the gate admits ints up to 4
    bytes). Ingest widens int8 to int32 in both packages, so the port's
    table is built from int8 host columns and held against JAX's rows of
    the same values."""
    j, p = contexts
    t = tables()["t"]
    q = harkdb_tpu_torch.Context(device="cpu")
    q.tables["t"] = Table.from_host("t", {"k": t["k"], "b8": t["b8"]},
                                    ["k", "b8"], {}, q.config, "cpu")
    assert q.tables["t"].columns["b8"].dtype == torch.int8
    for sql in ("select k, b8 from t order by b8 limit 20",
                "select k, b8 from t order by b8 desc limit 20 offset 4"):
        np.testing.assert_array_equal(q.sql(sql), j.sql(sql))
    assert spy == [20, 24]


# -- the selection itself ---------------------------------------------------------

def _views(rng, n):
    return {
        "random": rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(
            np.int32),
        "tied": rng.integers(0, 4, n).astype(np.int32),
        "one_value": np.full(n, -5, np.int32),
        "extremes": rng.choice(np.array([I32_MIN, I32_MAX, 0, -1],
                                        np.int32), n),
    }


@pytest.mark.parametrize("name", ["random", "tied", "one_value", "extremes"])
def test_top_k_indices_matches_its_plain_version_and_lax(name):
    rng = np.random.default_rng(["random", "tied", "one_value",
                                 "extremes"].index(name))
    view = _views(rng, 100_000)[name]
    tv = torch.from_numpy(view)
    for k in (0, 1, 10, 1024, 100_000):
        got = top_k_indices(tv, k)
        assert got.dtype == torch.int64 and got.shape == (k,)
        np.testing.assert_array_equal(got.numpy(),
                                      top_k_indices_reference(tv, k).numpy())
        if k in (10, 1024):
            want = np.asarray(jax.lax.top_k(jnp.asarray(view), k)[1])
            np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_indices_rejects_what_it_cannot_order():
    with pytest.raises(ValueError, match="int32"):
        top_k_indices(torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError, match="outside"):
        top_k_indices(torch.zeros(4, dtype=torch.int32), 5)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.float32])
@pytest.mark.parametrize("descending", [False, True])
def test_view_and_selection_match_jax_per_dtype(dtype, descending):
    """``ieee_order_view`` and the selection over it, per key dtype the
    gate admits, against JAX's view and ``lax.top_k``."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    n = 5000
    if dtype == np.float32:
        key = special_floats(rng, n)
    else:
        info = np.iinfo(dtype)
        key = rng.integers(info.min, int(info.max) + 1, n).astype(dtype)
        key[:4] = [info.min, info.max, info.min, info.max]
    want_view = np.asarray(jax_view(jnp.asarray(key), descending))
    got_view = ieee_order_view(torch.from_numpy(key), descending)
    np.testing.assert_array_equal(got_view.numpy(), want_view)
    want = np.asarray(jax.lax.top_k(jnp.asarray(want_view), 300)[1])
    np.testing.assert_array_equal(top_k_indices(got_view, 300).numpy(),
                                  want)
