"""harkdb_tpu_torch.parallel.skew vs harkdb_tpu.parallel.skew, on the CPU.

Every case of tests/test_skew.py: hot-key detection (on live rows, not the
padded capacity), the membership / salted-routing / build-replication
primitives, and the skewed joins end to end, salted and not. The port's
ranks run in a pool of 4 gloo processes (``torch_mesh_pool``); results
must equal ``harkdb_tpu.Context(mesh=make_engine_mesh(4))``'s bit for bit
on every rank, and a 90%-one-key probe side must nominate the hot set
JAX's ``detect_hot_keys`` nominates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import PartitionSpec as P

from harkdb_tpu import EngineConfig as JaxConfig
from harkdb_tpu.parallel import make_engine_mesh as jax_mesh
from harkdb_tpu.parallel import shard_batch as jax_shard_batch
from harkdb_tpu.parallel.skew import detect_hot_keys as jax_detect
from harkdb_tpu_torch.parallel.skew import (
    is_member, replicate_hot_build, salted_probe_dest,
)
from torch_mesh_pool import assert_same, jax_sql, shared_pool

D = 4


@pytest.fixture(scope="module")
def pool():
    return shared_pool(D)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(D)


def skewed_tables(rng, n=2000, hot_frac=0.9, hot_key=3):
    lk = np.where(rng.random(n) < hot_frac, hot_key,
                  rng.integers(0, 100, n)).astype(np.int32)
    ldf = pd.DataFrame({"k": lk, "a": np.arange(n, dtype=np.int32)})
    rdf = pd.DataFrame({"j": np.arange(0, 100, dtype=np.int32),
                        "b": rng.integers(0, 1000, 100).astype(np.int32)})
    return {"l": ldf, "r": rdf}


def jax_hot(jmesh, k, counts=None):
    """JAX's hot set for ``k`` sharded over ``jmesh`` (or ``k`` as D equal
    blocks with the given live counts)."""
    if counts is None:
        sb = jax_shard_batch({"k": k}, k.shape[0], jmesh, JaxConfig())
        cols, cnt = sb.columns, sb.shard_counts
    else:
        from jax.sharding import NamedSharding

        sharding = NamedSharding(jmesh, P("shards"))
        cols = {"k": jax.device_put(k, sharding)}
        cnt = jax.device_put(np.asarray(counts, np.int32), sharding)

    def body(cols, cnt):
        H, HV = jax_detect(cols["k"], cnt[0], D, 0.25, "shards")
        return H, HV.astype(jnp.int32)

    f = jax.jit(jax.shard_map(body, mesh=jmesh,
                              in_specs=({"k": P("shards")}, P("shards")),
                              out_specs=(P(), P()), check_vma=False))
    H, HV = f(cols, cnt)
    return sorted(np.asarray(H)[np.asarray(HV) > 0].tolist())


class TestDetection:
    def test_hot_key_detected(self, pool, jmesh):
        rng = np.random.default_rng(0)
        n = 1024
        k = np.where(rng.random(n) < 0.8, 7,
                     rng.integers(100, 200, n)).astype(np.int32)
        want = jax_hot(jmesh, k)
        assert 7 in want
        assert pool.run("hot_keys", k) == [want] * D

    def test_prefiltered_shard_still_detects(self, pool, jmesh):
        """The threshold is on LIVE rows: 26 of each rank's 32 live rows of
        1024 hold key 7 and must nominate it."""
        rng = np.random.default_rng(0)
        C, live = 1024, 32
        k = rng.integers(100, 200, C * D).astype(np.int32)
        for i in range(D):
            k[i * C: i * C + 26] = 7
        want = jax_hot(jmesh, k, [live] * D)
        assert 7 in want
        assert pool.run("hot_keys", k, live) == [want] * D

    def test_uniform_keys_not_hot(self, pool, jmesh):
        k = np.random.default_rng(0).permutation(1024).astype(np.int32)
        assert jax_hot(jmesh, k) == []
        assert pool.run("hot_keys", k) == [[]] * D

    def test_ninety_percent_join_key_matches_jax(self, pool, jmesh):
        """The probe side of the skewed join below: the same hot set."""
        k = skewed_tables(np.random.default_rng(0))["l"]["k"].to_numpy()
        want = jax_hot(jmesh, k)
        assert 3 in want
        assert pool.run("hot_keys", k) == [want] * D


class TestPrimitives:
    def test_is_member(self):
        H = torch.tensor([5, 9, 0, 0], dtype=torch.int32)
        HV = torch.tensor([True, True, False, False])
        k = torch.tensor([5, 9, 0, 3], dtype=torch.int32)
        assert is_member(k, H, HV).tolist() == [True, True, False, False]

    def test_salted_probe_spread(self):
        n = 800
        k = torch.full((n,), 7, dtype=torch.int32)
        hot = torch.ones(n, dtype=torch.bool)
        dest = salted_probe_dest(k, hot, 8, 0).numpy()
        counts = np.bincount(dest, minlength=8)
        assert counts.min() == counts.max() == 100   # perfect spread

    def test_replicate_hot_build(self):
        cols = {"j": torch.tensor([7, 1, 2], dtype=torch.int32),
                "b": torch.tensor([70, 10, 20], dtype=torch.int32)}
        hot = torch.tensor([True, False, False])
        exp, total, dest = replicate_hot_build(
            cols, "j", torch.tensor(3, dtype=torch.int32), hot, 4,
            out_capacity=16)
        assert int(total) == 4 + 2          # hot row x4 + two singles
        assert (dest.numpy()[6:] == 4).all()    # slots past the total
        jj, dd = exp["j"].numpy()[:6], dest.numpy()[:6]
        assert sorted(dd[jj == 7].tolist()) == [0, 1, 2, 3]
        np.testing.assert_array_equal(exp["b"].numpy()[:4], [70] * 4)


class TestSkewedJoinE2E:
    @pytest.mark.parametrize("case", ["inner", "left", "groupby",
                                      "salting_disabled"])
    def test_matches_jax(self, pool, jmesh, case):
        rng = np.random.default_rng(0)
        cfg = None
        if case == "inner":
            tables = skewed_tables(rng)
            q = "select k, a, b from l join r on l.k = r.j"
        elif case == "left":
            tables = skewed_tables(rng, n=1000)
            tables["l"].loc[0, "k"] = 5000       # unmatched hot-side row
            q = "select k, a, b from l left join r on l.k = r.j"
        elif case == "groupby":
            tables = skewed_tables(rng)
            q = ("select k, sum(a), max(b), count(*) from l "
                 "join r on l.k = r.j group by k")
        else:
            cfg = {"skew_salted_join": False}
            tables = skewed_tables(rng, n=500)
            q = "select k, a, b from l join r on l.k = r.j"
        expect = jax_sql(jmesh, tables, [q], cfg)
        assert_same(expect, pool.run("run_sql", tables, [q], cfg), [q])
