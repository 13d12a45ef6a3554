"""harkdb_tpu_torch.parallel vs harkdb_tpu.parallel, on the CPU.

The port's distributed layer runs in a pool of 4 gloo ranks
(``torch_mesh_pool.shared_pool``, one process per rank); the JAX package
runs the same tables on its 4-device virtual CPU mesh (its own tests hold
that mesh against its single device). Every rank's whole result must
equal JAX's mesh result: integers bit for bit,
floats within rtol 1e-6, ``sql_df`` NULLs in the same places, errors
verbatim, ``last_fast_span`` (and the cached probe) equal.

The corpus: every case of tests/test_parallel.py (the shuffle, the
distributed queries, the dense-key gate), tests/test_multihost.py as two
ranks, and the mesh cases of tests/test_strings.py, test_features.py,
test_count_distinct.py, test_sql_ext.py (``TestGroupByExpr``,
``TestVarianceFamily``, ``TestMedianQuantile``, ``TestTopKLimit``) and
test_parity.py (``TestGroupKeyOrder``). Beside it, the modules that hold
kernels against JAX's: ``hash_to_bucket``, ``segmented_iota``,
``replicated_iota``, ``compact_indices``, ``shard_batch``'s blocks and
``ShardedBatch``'s accessors; the mesh's own contract (errors, a mesh of
one rank, a failing or hanging rank); a window, a derived table and a set
operation on the mesh.
"""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import harkdb_tpu
import harkdb_tpu_torch
from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from harkdb_tpu.parallel import shard_batch as jax_shard_batch
from harkdb_tpu.parallel.shuffle import hash_to_bucket as jax_hash
from harkdb_tpu.prims.compaction import compact_indices as jax_compact_idx
from harkdb_tpu.prims.segmented import (
    replicated_iota as jax_rep_iota, segmented_iota as jax_seg_iota,
)
from harkdb_tpu_torch.parallel.shuffle import hash_to_bucket
from harkdb_tpu_torch.prims import (
    compact_indices, replicated_iota, segmented_iota,
)
from torch_mesh_pool import (
    MeshPool, RankError, assert_same, jax_sql, shared_pool,
)

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def check(pool, jmesh, tables, queries, cfg=None, frames=False):
    """Run ``queries`` on the JAX mesh and on every rank; every rank must
    equal JAX's mesh."""
    expect = jax_sql(jmesh, tables, queries, cfg, frames)
    got = pool.run("run_sql", tables, queries, cfg, frames)
    assert_same(expect, got, queries)
    return expect, got


def _pair_tables(seed=0):
    rng = np.random.default_rng(seed)
    n = 700
    t = pd.DataFrame({
        "k": rng.integers(0, 12, n).astype(np.int32),
        "v": rng.integers(-100, 100, n).astype(np.int32),
        "w": rng.integers(1, 50, n).astype(np.int32),
    })
    r = pd.DataFrame({
        "j": np.arange(12, dtype=np.int32),
        "m": rng.integers(1, 9, 12).astype(np.int32),
    })
    return {"t": t, "r": r}


# -- the modules that hold kernels, against JAX's ----------------------------

def _hash_keys():
    rng = np.random.default_rng(3)
    i32 = np.concatenate([
        np.array([0, 1, -1, 2**31 - 1, -2**31, -2**31 + 1, 2**31 - 2],
                 np.int32),
        rng.integers(-2**31, 2**31 - 1, 2000, dtype=np.int64).astype(
            np.int32),
    ])
    i64 = np.concatenate([
        np.array([0, -1, 2**63 - 1, -2**63, 2**32, 2**32 + 5, -2**40],
                 np.int64),
        rng.integers(-2**62, 2**62, 2000, dtype=np.int64),
    ])
    f32 = np.array([0.0, -0.0, 1.5, -2.5, 3e9, 5e9, np.nan, np.inf,
                    -np.inf, 123456.7], np.float32)
    return i32, i64, f32


@pytest.mark.parametrize("n_buckets", [2, 4, 8])
@pytest.mark.parametrize("salt", [0, 1, 7])
def test_hash_to_bucket_matches_jax(salt, n_buckets):
    """Every key lands in JAX's bucket: int32 extremes and negatives, int64
    keys (JAX under x64), float keys (XLA's saturating uint32 cast)."""
    i32, i64, f32 = _hash_keys()
    for keys in (i32, f32):
        got = hash_to_bucket(torch.from_numpy(keys), n_buckets, salt)
        want = np.asarray(jax_hash(jnp.asarray(keys), n_buckets, salt))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(
            keys.dtype))
        assert got.dtype == torch.int32
    with jax.enable_x64(True):
        want = np.asarray(jax_hash(jnp.asarray(i64), n_buckets, salt))
    got = hash_to_bucket(torch.from_numpy(i64), n_buckets, salt)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_spread_and_salt():
    keys = torch.arange(10000, dtype=torch.int32)
    counts = np.bincount(hash_to_bucket(keys, 8).numpy(), minlength=8)
    assert counts.min() > 800                       # roughly uniform
    b0 = hash_to_bucket(keys[:1000], 8, salt=0)
    assert (b0 != hash_to_bucket(keys[:1000], 8, salt=1)).any()


@pytest.mark.parametrize("case", range(4))
def test_segmented_and_replicated_iota_and_compact_indices(case):
    rng = np.random.default_rng(case)
    n = [1, 7, 300, 4097][case]
    flags = rng.random(n) < [0.0, 0.5, 0.1, 0.01][case]
    np.testing.assert_array_equal(
        segmented_iota(torch.from_numpy(flags)).numpy(),
        np.asarray(jax_seg_iota(jnp.asarray(flags))))
    reps = rng.integers(0, 4, n).astype(np.int32)
    for nv in (0, n // 2, n):
        for cap in (1, int(reps.sum()) + 3):
            got = replicated_iota(torch.from_numpy(reps), cap,
                                  torch.tensor(nv, dtype=torch.int32))
            want = jax_rep_iota(jnp.asarray(reps), cap, jnp.int32(nv))
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(want[0]))
            assert int(got[1]) == int(want[1])
        mask = rng.random(n) < 0.4
        got = compact_indices(torch.from_numpy(mask),
                              torch.tensor(nv, dtype=torch.int32))
        want = jax_compact_idx(jnp.asarray(mask), jnp.int32(nv))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("n,row_align", [(700, 1024), (5000, 64), (3, 1024),
                                         (0, 1024)])
def test_shard_batch_blocks_match_jax(pool, jmesh, n, row_align):
    """Rank i holds JAX's shard i: the same capacity, rows and count."""
    rng = np.random.default_rng(n)
    cols = {"a": rng.integers(-9, 9, n).astype(np.int32),
            "f": rng.standard_normal(n).astype(np.float32)}
    cfg = harkdb_tpu.EngineConfig(row_align=row_align)
    sb = jax_shard_batch(cols, n, jmesh, cfg)
    C = sb.local_capacity
    counts = np.asarray(sb.shard_counts)
    got = pool.run("shard_block", cols, n, {"row_align": row_align})
    for i, (block, count) in enumerate(got):
        assert count == counts[i]
        for name in cols:
            np.testing.assert_array_equal(
                block[name], np.asarray(sb.columns[name]).reshape(D, C)[i])


@pytest.mark.parametrize("n", [700, 0])
def test_sharded_batch_accessors_match_jax(pool, jmesh, n):
    """``n_shards``, ``global_capacity``, ``total_rows`` and ``to_batch``
    against JAX's ShardedBatch of the same table; after ``dist_orderby``,
    ``total_rows`` is every row and ``to_batch`` the sorted column on
    every rank (tests/test_dist_tail.py:138). ``to_batch`` pads with
    zeros, as JAX's does."""
    rng = np.random.default_rng(n + 1)
    cols = {"v": rng.integers(0, 1 << 30, n).astype(np.int32),
            "f": rng.standard_normal(n).astype(np.float32)}
    sb = jax_shard_batch(cols, n, jmesh)
    want = sb.to_batch()
    ranks = pool.run("sharded_accessors", cols, n)
    for name in ("sharded", "ordered"):
        caps = sum(r[name][3] for r in ranks)
        for r in ranks:
            shards, gcap, total, _local, batch, count = r[name]
            assert shards == sb.n_shards == D
            assert total == count == int(sb.total_rows()) == n
            assert gcap == caps
            for c, col in batch.items():
                assert not col[count:].any()
                if name == "sharded":
                    np.testing.assert_array_equal(
                        col[:count], np.asarray(want.columns[c])[:n])
                else:
                    perm = np.argsort(cols["v"], kind="stable")
                    np.testing.assert_array_equal(col[:count], cols[c][perm])
    assert ranks[0]["sharded"][1] == sb.global_capacity


def test_repartition_preserves_multiset_and_colocates(pool):
    rng = np.random.default_rng(0)
    n = 512
    k = rng.integers(0, 40, n).astype(np.int32)
    v = rng.integers(0, 1000, n).astype(np.int32)
    got = pool.run("repartition", {"k": k, "v": v}, "k", n)
    rows = [(a, b) for blk in got for a, b in zip(blk["k"], blk["v"])]
    assert sorted(rows) == sorted(zip(k.tolist(), v.tolist()))
    for r, blk in enumerate(got):                  # each key on its rank
        assert (hash_to_bucket(torch.from_numpy(blk["k"]), D).numpy()
                == r).all()


# -- tests/test_parallel.py ---------------------------------------------------

PARALLEL_QUERIES = {
    "projection": "select k, v from t",
    "where": "select v, w from t where v > 0 and w < 40",
    "groupby": "select k, sum(v), max(w), count(*) from t group by k",
    "groupby_having": "select k, sum(v) from t group by k "
                      "having count(*) > 40",
    "implicit_group": "select min(v), max(v), count(*) from t",
    "join": "select k, v, m from t join r on t.k = r.j",
    "join_groupby": "select j, sum(v), max(m) from t join r on t.k = r.j "
                    "group by j",
    "full_pipeline": "select k, sum(v), count(*) from t join r "
                     "on t.k = r.j where v > -50 group by k "
                     "having sum(v) != 0 order by k desc limit 7",
    "orderby_limit": "select v from t order by v desc, w limit 25",
    "empty_result": "select k from t where k > 1000",
    "static_span_engages": "select k, sum(v), count(*) from t group by k",
}


@pytest.mark.parametrize("name", list(PARALLEL_QUERIES))
def test_distributed_query(pool, jmesh, name):
    q = PARALLEL_QUERIES[name]
    expect, _got = check(pool, jmesh, _pair_tables(), [q])
    if name == "static_span_engages":
        assert expect[0][2] is not None


def test_avg(pool, jmesh):
    check(pool, jmesh, _pair_tables(), ["select k, avg(w) from t group by k"])


def test_multikey_groupby(pool, jmesh):
    rng = np.random.default_rng(0)
    t2 = pd.DataFrame({
        "a": rng.integers(0, 5, 300).astype(np.int32),
        "b": rng.integers(0, 4, 300).astype(np.int32),
        "x": rng.integers(0, 100, 300).astype(np.int32),
    })
    check(pool, jmesh, {"t2": t2}, ["select a, b, sum(x) from t2 "
                                    "group by a, b"])


def test_skewed_keys(pool, jmesh):
    """90% of rows share one key."""
    rng = np.random.default_rng(0)
    n = 1000
    k = np.where(rng.random(n) < 0.9, 3,
                 rng.integers(0, 50, n)).astype(np.int32)
    s = pd.DataFrame({"k": k, "v": rng.integers(0, 10, n).astype(np.int32)})
    check(pool, jmesh, {"s": s}, ["select k, sum(v), count(*) from s "
                                  "group by k"])


def test_probed_span_post_where(pool, jmesh):
    """The key range is proven only after the WHERE narrows a wide table:
    the all-reduced probe admits it to the dense pre-aggregate and is
    cached on the plan."""
    rng = np.random.default_rng(0)
    n = 4000
    wide = rng.integers(0, 1 << 22, n).astype(np.int32)
    sel = rng.random(n) < 0.5
    wide[sel] = rng.integers(0, 500, int(sel.sum()))
    w = pd.DataFrame({"k": wide,
                      "v": rng.integers(-50, 50, n).astype(np.int32)})
    q = "select k, sum(v), count(*) from w where k < 500 group by k"
    expect, got = check(pool, jmesh, {"w": w}, [q])
    assert expect[0][2] is not None and expect[0][3] not in (None, ())


def test_wide_span_stays_on_sort_path(pool, jmesh):
    rng = np.random.default_rng(0)
    n = 2000
    w = pd.DataFrame({"k": rng.integers(0, 1 << 22, n).astype(np.int32),
                      "v": rng.integers(-50, 50, n).astype(np.int32)})
    expect, _ = check(pool, jmesh, {"w": w},
                      ["select k, sum(v) from w group by k"])
    assert expect[0][2] is None


# -- mesh cases of the single-device corpora ---------------------------------

CITIES = ["amsterdam", "berlin", "cairo", "delhi", "el paso", "fez"]


def test_strings_distributed(pool, jmesh):
    """tests/test_strings.py ``TestStringDistributed``: a string GROUP BY
    with COUNT(DISTINCT) and a string-key join, decoded by sql_df."""
    rng = np.random.default_rng(0)
    n = 600
    t = pd.DataFrame({"city": rng.choice(CITIES, n),
                      "v": rng.integers(-50, 50, n).astype(np.int32)})
    left = pd.DataFrame({
        "name": rng.choice(["ada", "bob", "cyd", "dan"], 300),
        "x": rng.integers(0, 100, 300).astype(np.int32)})
    right = pd.DataFrame({"who": ["bob", "dan", "eve"],
                          "y": np.array([7, 8, 9], dtype=np.int32)})
    check(pool, jmesh, {"t": t, "l": left, "r": right}, [
        "select city, sum(v) as s, count(distinct city) as d from t "
        "where city >= 'b' group by city order by s desc",
        "select l.name, l.x, r.y from l join r on l.name = r.who "
        "order by l.x, l.name",
    ], frames=True)


def test_left_join_distributed(pool, jmesh):
    """tests/test_features.py ``TestLeftJoin.test_distributed_matches``."""
    rng = np.random.default_rng(0)
    ldf = pd.DataFrame({"k": rng.integers(0, 30, 300).astype(np.int32),
                        "a": np.arange(300, dtype=np.int32)})
    rdf = pd.DataFrame({"j": rng.integers(0, 30, 100).astype(np.int32),
                        "b": np.arange(100, dtype=np.int32)})
    check(pool, jmesh, {"l": ldf, "r": rdf},
          ["select k, a, b from l left join r on l.k = r.j"])


def test_count_distinct_distributed(pool, jmesh):
    """tests/test_count_distinct.py ``test_distributed_matches_single_chip``
    and ``test_distributed_overlapping_values`` (one value on every rank
    counts once)."""
    rng = np.random.default_rng(0)
    n = 900
    t = pd.DataFrame({"k": rng.integers(0, 11, n).astype(np.int32),
                      "v": rng.integers(0, 20, n).astype(np.int32),
                      "w": rng.integers(-30, 30, n).astype(np.int32)})
    check(pool, jmesh, {"t": t}, [
        "select k, count(distinct v) from t group by k",
        "select k, count(distinct v), sum(w), min(w) from t group by k",
        "select count(distinct v) from t",
        "select k, count(distinct v), count(distinct w) from t "
        "where w > -10 group by k order by k desc",
    ])
    same = pd.DataFrame({"k": np.zeros(800, np.int32),
                         "v": np.full(800, 42, np.int32)})
    _e, got = check(pool, jmesh, {"t": same}, [
        "select k, count(distinct v), count(*) from t group by k"])
    for entries in got:
        np.testing.assert_array_equal(entries[0][1], [[0, 1, 800]])


def test_group_by_expression_distributed(pool, jmesh):
    """tests/test_sql_ext.py ``TestGroupByExpr.test_distributed_parity``."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"k": rng.integers(0, 50, 400).astype(np.int32),
                      "v": rng.integers(0, 1000, 400).astype(np.int32)})
    check(pool, jmesh, {"t": t}, [
        "select v % 7 as b, count(*) as n, sum(v) as s from t "
        "group by v % 7 order by b",
        "select k / 10 as d, max(v) as mx from t group by k / 10 "
        "order by d",
    ], frames=True)


def test_variance_family_distributed(pool, jmesh):
    """tests/test_sql_ext.py ``TestVarianceFamily.test_distributed_parity``
    (stddev / var_pop with HAVING on stddev), on its fixture's table."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"k": rng.integers(0, 6, 200).astype(np.int32),
                      "v": rng.integers(0, 100, 200).astype(np.int32)})
    check(pool, jmesh, {"t": t}, [
        "select k, stddev(v) as sd, var_pop(v) as vp from t "
        "group by k having stddev(v) > 0 order by k"], frames=True)


def test_median_quantile_distributed(pool, jmesh):
    """tests/test_sql_ext.py ``TestMedianQuantile.test_distributed_parity``:
    the raw-row exchange path."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"k": rng.integers(0, 8, 300).astype(np.int32),
                      "v": rng.integers(0, 1000, 300).astype(np.int32)})
    check(pool, jmesh, {"t": t}, [
        "select k, median(v) as md, quantile(v, 0.75) as q3, "
        "sum(v) as s from t group by k order by k"], frames=True)


def test_top_k_limit_distributed(pool, jmesh):
    """tests/test_sql_ext.py ``TestTopKLimit.test_distributed_parity``."""
    rng = np.random.default_rng(0)
    t = pd.DataFrame({"k": rng.integers(0, 500, 5000).astype(np.int32),
                      "v": rng.integers(-500, 500, 5000).astype(np.int32),
                      "f": rng.normal(0, 10, 5000).astype(np.float32)})
    check(pool, jmesh, {"t": t}, [
        "select k, v from t order by v limit 9",
        "select k, sum(v) as s from t group by k order by s desc limit 5",
    ], frames=True)


def test_compat_u32_key_order_distributed(pool, jmesh):
    """tests/test_parity.py ``TestGroupKeyOrder.
    test_compat_distributed_matches_single_chip``: negative keys after the
    positive ones."""
    t = pd.DataFrame({"k": np.array([3, -2, 0, -2, 3, -1, 0, 7], np.int32),
                      "v": np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)})
    check(pool, jmesh, {"t": t},
          ["select k, sum(v), min(v) from t group by k"],
          cfg={"compat_u32_key_order": True})


def test_subqueries_run_over_the_mesh(pool, jmesh):
    """An IN subquery and a scalar subquery run through the distributed
    executor, every rank substituting the same values."""
    t = _pair_tables()
    check(pool, jmesh, t, [
        "select k, v from t where k in (select j from r where m > 4) "
        "order by v, k limit 20",
        "select k, count(*) from t where v > (select avg(v) from t) "
        "group by k",
    ])


def test_features_not_distributed_raise(pool, jmesh):
    """A window function, a derived table and a set operation run on a
    mesh of four ranks, each rank equal to JAX's mesh (the test's name is
    from when the port raised NotImplementedError for them)."""
    t = _pair_tables()
    check(pool, jmesh, t, [
        "select k, row_number() over (partition by k order by v) from t",
        "select d.k from (select k from t) d",
        "select k from t union select j from r",
    ])


# -- the mesh's own contract --------------------------------------------------

def test_mesh_of_one_rank_runs_single_device(pool):
    """A mesh of one rank takes the single-device path; a mesh asked for
    more ranks than its group has raises."""
    t = _pair_tables()
    q = PARALLEL_QUERIES["full_pipeline"]
    c = harkdb_tpu_torch.Context(device="cpu")
    for name, src in t.items():
        c.create_table(name, src)
    for res, distributed, size, too_many in pool.run("size_one_mesh", t, q):
        assert size == 1 and distributed is False
        np.testing.assert_array_equal(res, c.sql(q))
        assert too_many == (f"Requested a mesh of {D + 1} ranks, but the "
                            f"process group has {D}")


def test_make_engine_mesh_needs_a_group():
    from harkdb_tpu_torch.parallel import make_engine_mesh

    with pytest.raises(RuntimeError, match="torchrun"):
        make_engine_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        harkdb_tpu_torch.Context(device="cpu", mesh=make_engine_mesh())


def test_make_engine_mesh_refuses_a_renamed_axis():
    from harkdb_tpu_torch.parallel import make_engine_mesh

    cfg = harkdb_tpu_torch.EngineConfig(mesh_axis="rows")
    with pytest.raises(ValueError, match="mesh_axis='rows'"):
        make_engine_mesh(config=cfg, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "with no card: the default device is the card")
def test_init_multihost_defaults_to_the_card():
    """Ranks run on a card unless the caller asks for the CPU: with no card
    visible and no device given, init_multihost raises before it joins."""
    from harkdb_tpu_torch.parallel.multihost import init_multihost

    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_multihost("127.0.0.1:1", 2, 0)


def test_failing_or_hanging_rank_fails_within_its_timeout():
    """A rank that raises fails the call (the others' collective times
    out); a rank that hangs makes the call raise TimeoutError and the pool
    is killed — both within seconds."""
    import time

    p = MeshPool(2, collective_timeout_s=2, call_timeout_s=30)
    try:
        t0 = time.monotonic()
        with pytest.raises(RankError, match="on purpose"):
            p.run("fail_or_hang", "raise")
        assert time.monotonic() - t0 < 20
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            p.run("fail_or_hang", "hang", timeout_s=3)
        assert time.monotonic() - t0 < 10
    finally:
        p.close(kill=True)


# -- tests/test_multihost.py, as two ranks ------------------------------------

def _two_ranks(fn):
    import torch_mesh_pool as P

    ctx = multiprocessing.get_context("spawn")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    results = ctx.Queue()
    procs = [ctx.Process(target=P.multihost_worker,
                         args=(fn, coord, 2, i, results), daemon=True)
             for i in range(2)]
    for p in procs:
        p.start()
    try:
        return sorted(results.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()


def test_two_process_shuffle():
    assert _two_ranks("worker_demo") == [(0, "OK 512"), (1, "OK 512")]


def test_two_process_sql_end_to_end():
    """A join + WHERE + GROUP BY + HAVING + ORDER BY query, an ungrouped
    ORDER BY ... LIMIT and a DISTINCT across the process boundary: every
    rank collects the whole result, equal to the single-device answer."""
    got = _two_ranks("worker_sql")
    assert got == [(0, "SQL OK 9x4"), (1, "SQL OK 9x4")], got
