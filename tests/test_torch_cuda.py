"""harkdb_tpu_torch's CUDA kernels on the card (marker ``gpu``).

Repeats chip_smoke.py's phase 3 — each kernel held against its plain
PyTorch version on edge cases (for kernels D and C also at the edges of
their tiles and clusters, on runs of empty segments and under every
histogram shape), where a decoupled look-back can go wrong and at the main
paths' shapes — holds the
running max / min (kernel B over one segment) against ``torch.cummax`` /
``torch.cummin``, and checks the main query, the joins, the dense-key
GROUP BY and the nested queries (windows, set operations, a CTE, EXISTS,
IN and a correlated subquery) on the card against the CPU port; loads a
numeric CSV onto the card through the native loader, finds kernels A and B
in a ``Context.profile`` trace and runs queries under ``debug_checks``;
runs the public primitives (``prims``) against their CPU plain results
and the top-k LIMIT path against the CPU port; checks that the entry
points with no device argument put their data on the card, and runs
chip_smoke's phase 12 (the public ``ops`` and ``kernels`` entry points) at
2^16 rows; runs 200 queries of the benchmark's TPC-H power mix at 1%
of SF 10, holding the card's memory flat; and holds the join's count-phase
kernels (words and runs) to their plain versions bit for bit, from lengths
around their tiles to a 65536² CROSS JOIN and 120M + 2,557 rows.
Whether a card is present
is decided in the fixture, so machines without one skip these tests with
the reason. Run on a card with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

(``--noconftest``: tests/conftest.py pins JAX to the CPU and needs jax,
which these tests do not use.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device; the kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def test_kernel_edge_cases(cuda):
    import chip_smoke
    from harkdb_tpu_torch.kernels import compact, segscan

    chip_smoke.phase_kernels(torch, compact, segscan, cuda)


def test_kernels_where_a_look_back_can_fail(cuda):
    """One segment over 2048 tiles both ways, all / no rows kept, 2^26
    rows and 50 repeats at 2^24 rows, each against the plain version."""
    import chip_smoke
    from harkdb_tpu_torch.kernels import compact, segscan

    chip_smoke.phase_lookback(torch, compact, segscan, cuda)


def test_kernels_at_main_path_shapes(cuda):
    import chip_smoke
    from harkdb_tpu_torch.kernels import compact, segscan

    (k, v, mask), (sid, vals) = chip_smoke.main_shapes(torch, cuda)
    n_valid = torch.full((), k.shape[0], dtype=torch.int32, device=cuda)
    assert chip_smoke.check_main_compact(torch, compact, k, v, mask,
                                         n_valid) == 0
    got = segscan.flat_segscan("max", sid, [vals], -2**31)[0]
    ref = segscan.flat_segscan_reference("max", sid, [vals], -2**31)[0]
    assert torch.equal(got, ref)


def test_main_query_matches_cpu_port(cuda):
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.kernels import compact, segscan

    rng = np.random.default_rng(0)
    n = 200_000
    data = {"k": rng.integers(0, 1 << 14, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    q = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
         "where v > 0 group by k order by s desc")
    on_card = H.Context(device=cuda)
    on_cpu = H.Context(device="cpu")
    on_card.create_table("t", data)
    on_cpu.create_table("t", data)
    compact.LAUNCHES = segscan.LAUNCHES = 0
    got = on_card.sql(q)
    assert compact.LAUNCHES >= 2 and segscan.LAUNCHES >= 1
    np.testing.assert_array_equal(got, on_cpu.sql(q))


def test_cuda_tensor_never_takes_plain_version(cuda):
    from harkdb_tpu_torch.kernels import compact, segscan

    x = torch.arange(10, dtype=torch.int32, device=cuda)
    before = (compact.LAUNCHES, segscan.LAUNCHES,
              segscan.ONE_SEGMENT_LAUNCHES)
    compact.flat_compact({"x": x}, x > 3,
                         torch.full((), 10, dtype=torch.int32, device=cuda))
    segscan.flat_segscan("add", torch.zeros_like(x), [x], 0)
    segscan.flat_segscan("max", None, [x], -2**31, reverse=True)
    assert (compact.LAUNCHES, segscan.LAUNCHES,
            segscan.ONE_SEGMENT_LAUNCHES) == (before[0] + 1, before[1] + 2,
                                              before[2] + 1)


def test_kernels_c_d_edge_cases(cuda):
    import chip_smoke
    from harkdb_tpu_torch.kernels import expand, matmul_agg

    chip_smoke.phase_kernels_cd(torch, expand, matmul_agg, cuda)


def test_kernels_c_d_at_slice_shapes(cuda):
    import chip_smoke
    from harkdb_tpu_torch.kernels import expand, matmul_agg

    d_star, d_q3, c_main = chip_smoke.cd_shapes(torch, cuda)
    d_err, c_err, _one, _wide = chip_smoke.check_cd_main(
        torch, expand, matmul_agg, cuda, d_star, d_q3, c_main)
    assert d_err == 0 and c_err == 0


JOIN_QUERIES = [
    "select g, sum(v) as s, count(*) as c from f join d on f.k = d.j "
    "where v > 0 group by g order by g",
    "select f.k, f.v, d.g from f left join d on f.k = d.j "
    "order by f.k, f.v, d.g",
    "select f.k, d.j, d.g from f right join d on f.k = d.j "
    "order by d.j, f.k, f.v",
    "select f.k, f.v, d.j from f full outer join d on f.k = d.j "
    "and f.v = d.g order by f.k nulls last, f.v, d.j",
    "select count(*) as n, sum(f.v) as s from f cross join d where d.j < 3",
    "select d.g, count(f.v) as c, sum(f.v) as s from f left join d "
    "on f.k = d.j group by d.g order by d.g",
]


def test_join_queries_match_cpu_port(cuda):
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.kernels import expand, matmul_agg

    rng = np.random.default_rng(5)
    f = {"k": rng.integers(0, 300, 20_000).astype(np.int32),
         "v": rng.integers(-50, 50, 20_000).astype(np.int32)}
    d = {"j": rng.permutation(400)[:250].astype(np.int32),
         "g": rng.integers(0, 40, 250).astype(np.int32)}
    on_card = H.Context(device=cuda)
    on_cpu = H.Context(device="cpu")
    for c in (on_card, on_cpu):
        c.create_table("f", f)
        c.create_table("d", d)
    expand.LAUNCHES = matmul_agg.LAUNCHES = 0
    for q in JOIN_QUERIES:
        np.testing.assert_array_equal(on_card.sql(q), on_cpu.sql(q),
                                      err_msg=q)
        assert on_card._plan(q).last_fast_span == on_cpu._plan(
            q).last_fast_span
    assert expand.LAUNCHES >= len(JOIN_QUERIES)
    assert matmul_agg.LAUNCHES >= 1


def test_join_memory_grows_with_the_output_not_the_input(cuda):
    """A 2^24-row fact joined to a 10^5-row dimension filtered to 1% of
    its rows, carrying 1 and then 8 fact columns: each result equals the
    CPU path's, slot for slot, and the join's peak memory grows by less
    than one input column's bytes (2^24 x 4 B) from 1 carried column to 8,
    since a carried column is read once, at the output's size."""
    from harkdb_tpu_torch.columnar.batch import ColumnBatch
    from harkdb_tpu_torch.ops.join import join_batches

    rng = np.random.default_rng(24)
    n, nd, live_d = 1 << 24, 100_000, 1_000
    fact = {"fk": rng.integers(0, nd, n).astype(np.int32)}
    for i in range(8):
        fact[f"c{i}"] = (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
                         if i % 2 else rng.standard_normal(n).astype(
                             np.float32))
    dim = {"dk": rng.permutation(nd).astype(np.int32),
           "dv": rng.integers(0, 100, nd).astype(np.int32)}

    def batch(arrays, n_valid, dev):
        return ColumnBatch({k: torch.from_numpy(v).to(dev)
                            for k, v in arrays.items()},
                           torch.tensor(n_valid, dtype=torch.int32,
                                        device=dev))

    def join(n_carried, dev):
        names = ["fk"] + [f"c{i}" for i in range(n_carried)]
        left = batch({k: fact[k] for k in names}, n, dev)
        right = batch(dim, live_d, dev)
        total = int(np.isin(fact["fk"], dim["dk"][:live_d]).sum())
        cap = 1 << max(total - 1, 1).bit_length()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = join_batches(left, right, "fk", "dk", cap)
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
        assert int(out.n_valid) == total
        return out, peak

    peaks = {}
    for k in (1, 8):
        got, peaks[k] = join(k, cuda)
        want, _ = join(k, torch.device("cpu"))
        assert got.names == want.names
        for name in want.names:
            assert torch.equal(got.columns[name].cpu(), want.columns[name]), (
                k, name)
        del got, want
    assert peaks[8] - peaks[1] < n * 4, peaks


def test_running_max_min_on_card_match_cummax(cuda):
    from harkdb_tpu_torch.kernels import segscan
    from harkdb_tpu_torch.prims.scan import running_max, running_min

    rng = np.random.default_rng(6)
    for n in (0, 1, 1023, 1024, 1025, 1 << 20):
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
        cpu = torch.from_numpy(x)
        for fn, scan in ((running_max, torch.cummax),
                         (running_min, torch.cummin)):
            for rev in (False, True):
                want = (torch.flip(scan(torch.flip(cpu, [0]), 0).values, [0])
                        if rev else scan(cpu, 0).values)
                before = segscan.LAUNCHES
                got = fn(cpu.to(cuda), reverse=rev).cpu()
                assert torch.equal(got, want), (n, fn.__name__, rev)
                assert segscan.LAUNCHES == before + (1 if n else 0)


NESTED_QUERIES = [
    "select k, v, row_number() over (partition by k order by v) as rn, "
    "rank() over (partition by k order by v) as rk, "
    "sum(v) over (partition by k order by v) as rs from t where v > 0",
    "select k, min(v) over (partition by k order by v rows between 2 "
    "preceding and 1 following) as m from t order by k, v",
    "select k from t where v > 900 intersect select k from t "
    "where v < -900 order by k",
    "select k from t where v > 990 union select k from t where v < -990 "
    "except select k from t where k < 100 order by 1",
    "with s as (select k, sum(v) as sv from t group by k) "
    "select count(*) as n, sum(sv) as tot from s where sv > 0",
    "select k, count(*) as n from t where exists (select 1 from t t2 "
    "where t2.k = t.k and t2.v > 995) group by k order by k",
    "select count(*) as n from t where k in (select k from t where v > 998)",
    "select sum(v) as s from t where v < (select avg(v) from t t2 "
    "where t2.k = t.k)",
]


def test_nested_queries_match_cpu_port(cuda):
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.kernels import compact, segscan

    rng = np.random.default_rng(7)
    n = 100_000
    data = {"k": rng.integers(0, 5000, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    on_card = H.Context(device=cuda)
    on_cpu = H.Context(device="cpu")
    on_card.create_table("t", data)
    on_cpu.create_table("t", data)
    compact.LAUNCHES = segscan.LAUNCHES = 0
    for q in NESTED_QUERIES:
        np.testing.assert_array_equal(on_card.sql(q), on_cpu.sql(q),
                                      err_msg=q)
    assert compact.LAUNCHES >= len(NESTED_QUERIES)
    assert segscan.LAUNCHES >= 4


def test_power_stream_leaves_nothing_on_the_card(cuda):
    """200 queries of the benchmark's TPC-H power mix at 1% of SF 10, new
    literals every query, so most plans are new and Q4's, Q13's, Q17's and
    Q18's inner plans run on every execution: card memory after the last
    query is within 64 MB of its value after the first, and no query
    leaves more than 64 MB beyond the tables (``held_bytes``)."""
    import os
    import sys

    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import harkdb_tpu_torch as H
    from harness import registry
    from harness.cell import scaled_rows
    from harness.traffic import Mix

    cfg = registry.config("tpch-sf10")
    tables = registry.module("gen", cfg["generator"]).make_tables(
        scaled_rows(cfg, 0.01), 2**31 + 18, cuda)
    ctx = H.Context(device=cuda)
    for name, cols in tables.items():
        ctx.create_table(name, cols)
    queries = Mix(registry.mix_path("power")).queries(2**31 + 18)
    allocated, held, inner = [], [], 0
    for _ in range(200):
        ctx.sql(next(queries).sql)
        allocated.append(torch.cuda.memory_allocated(cuda))
        held.append(ctx.last_metrics.held_bytes)
        inner += ctx.last_metrics.inner_plans_run
    assert abs(allocated[-1] - allocated[0]) <= 64 << 20, allocated
    assert 0 <= min(held) and max(held) <= 64 << 20, held
    assert inner >= 4 * 200 // 12


def test_new_kernels_never_take_plain_version(cuda):
    from harkdb_tpu_torch.kernels import expand, matmul_agg

    offs = torch.arange(0, 20, 2, dtype=torch.int32, device=cuda)
    nv = torch.full((), 10, dtype=torch.int32, device=cuda)
    before = (expand.LAUNCHES, matmul_agg.LAUNCHES)
    expand.expand_fills(offs, nv, 32, [offs])
    matmul_agg.onehot_groupby_sums(offs, [offs], nv, 0, 32)
    assert (expand.LAUNCHES, matmul_agg.LAUNCHES) == (before[0] + 1,
                                                      before[1] + 1)


def test_csv_loads_on_card_like_dict(cuda, tmp_path):
    """A numeric CSV goes through the native loader onto the card and
    answers as the dict-loaded table does."""
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(8)
    n = 100_000
    k = rng.integers(0, 5000, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    path = tmp_path / "t.csv"
    with open(path, "w") as f:
        f.write("k,v\n")
        np.savetxt(f, np.stack([k, v], axis=1), fmt="%d", delimiter=",")
    q = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
         "where v > 0 group by k order by s desc")
    from_csv = H.Context(device=cuda)
    from_csv.create_table("t", str(path))
    assert from_csv.tables["t"].columns["k"].is_cuda
    from_dict = H.Context(device=cuda)
    from_dict.create_table("t", {"k": k, "v": v})
    np.testing.assert_array_equal(from_csv.sql(q), from_dict.sql(q))


def test_profile_trace_names_the_kernels(cuda, tmp_path):
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(9)
    n = 200_000
    c = H.Context(device=cuda)
    c.create_table("t", {"k": rng.integers(0, 1 << 14, n).astype(np.int32),
                         "v": rng.integers(-1000, 1000, n).astype(np.int32)})
    q = ("select k, sum(v) as s, max(v) as m, count(*) as c from t "
         "where v > 0 group by k order by s desc")
    np.testing.assert_array_equal(c.profile(q, str(tmp_path)), c.sql(q))
    (trace,) = tmp_path.iterdir()
    text = trace.read_text()
    assert "compact_kernel" in text and "segscan_kernel" in text


def test_debug_checks_on_card(cuda):
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(10)
    n = 100_000
    data = {"k": rng.integers(0, 300, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32)}
    dims = {"j": np.arange(300, dtype=np.int32),
            "w": rng.integers(-1000, 1000, 300).astype(np.int32)}
    checked = H.Context(H.EngineConfig(debug_checks=True), device=cuda)
    plain = H.Context(device=cuda)
    for c in (checked, plain):
        c.create_table("t", data)
        c.create_table("d", dims)
    for q in ("select k, sum(v) as s from t where v > 0 group by k "
              "order by s desc",
              "select t.k, t.v, d.w from t join d on t.k = d.j "
              "where t.v < d.w order by t.k, t.v, d.w"):
        np.testing.assert_array_equal(checked.sql(q), plain.sql(q))


def _counters():
    from harkdb_tpu_torch.kernels import (
        compact, expand, join_runs, matmul_agg, segscan,
    )

    return {"flat_compact": (compact, "LAUNCHES"),
            "flat_segscan": (segscan, "LAUNCHES"),
            "flat_segscan_one_segment": (segscan, "ONE_SEGMENT_LAUNCHES"),
            "onehot_groupby_sums": (matmul_agg, "LAUNCHES"),
            "expand_fills": (expand, "LAUNCHES"),
            "join_words": (join_runs, "WORDS_LAUNCHES"),
            "join_runs": (join_runs, "RUNS_LAUNCHES")}


def test_prims_on_card_match_cpu(cuda):
    """chip_smoke's phase 11 (a) at 2^16 rows: each primitive launches its
    kernels (A, B or D), runs no plain version on the card and equals its
    CPU plain result."""
    import chip_smoke

    chip_smoke.phase_prims(torch, _counters(), cuda, n=1 << 16)


def test_prims_eight_byte_types_raise_on_card(cuda):
    import harkdb_tpu_torch.prims as P

    flags = torch.tensor([True, False, True], device=cuda)
    vals = torch.arange(3, dtype=torch.int64, device=cuda)
    for fn in (lambda: P.segmented_scan(torch.add, 0, flags, vals),
               lambda: P.segmented_reduce(torch.maximum, 0, flags, vals)):
        with pytest.raises(ValueError, match="at most 4 bytes"):
            fn()


def test_top_k_path_on_card_matches_cpu_port(cuda):
    """The top-k queries of tests/test_torch_topk.py on the card against
    the CPU port, with one selection each at a LIMIT of at most 1024."""
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.plan import planner
    from torch_topk_cases import QUERIES, assert_same, tables

    ctxs = {}
    for dev in ("cpu", cuda):
        ctxs[str(dev)] = H.Context(device=dev)
        for name, src in tables().items():
            ctxs[str(dev)].create_table(name, src)
    real, calls = planner.top_k_indices, []

    def spy(view, k):
        calls.append(k)
        return real(view, k)

    planner.top_k_indices = spy
    try:
        for query, topk in QUERIES:
            want = ctxs["cpu"].sql(query)
            calls.clear()
            got = ctxs[str(cuda)].sql(query)
            assert_same(want, got, query)
            assert len(calls) == int(topk), query
    finally:
        planner.top_k_indices = real


def test_entry_points_default_to_the_card(cuda):
    """``Table``, ``Table.from_host``, ``tables_from_reference`` and
    ``ColumnBatch.from_numpy`` with no device argument put every tensor on
    the card; a join of two such batches launches kernel D and equals the
    same join on the CPU."""
    import harkdb_tpu_torch as H
    from harkdb_tpu_torch.columnar.batch import ColumnBatch
    from harkdb_tpu_torch.kernels import expand
    from harkdb_tpu_torch.ops import join_batches

    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 500, 4000).astype(np.int32),
            "v": rng.integers(-9, 9, 4000).astype(np.int32)}
    dims = {"j": rng.permutation(600).astype(np.int32),
            "g": rng.integers(0, 50, 600).astype(np.int32)}
    t = H.Table("t", data)
    tables = {"t": t, "h": H.Table.from_host("h", data, ["k", "v"], {}),
              **H.tables_from_reference({"r": t})}
    for name, table in tables.items():
        assert table.device.type == "cuda", name
        assert all(c.is_cuda for c in table.columns.values()), name
        assert table.batch().n_valid.is_cuda, name
    on_card = [ColumnBatch.from_numpy(d) for d in (data, dims)]
    for b in on_card:
        assert b.device.type == "cuda"
        assert all(c.is_cuda for c in b.columns.values())
    on_cpu = [ColumnBatch.from_numpy(d, device="cpu") for d in (data, dims)]
    expand.LAUNCHES = 0
    got = join_batches(*on_card, "k", "j", 4000, kind="left")
    torch.cuda.synchronize()
    assert expand.LAUNCHES >= 1
    want = join_batches(*on_cpu, "k", "j", 4000, kind="left")
    assert int(got.n_valid) == int(want.n_valid) == 4000
    assert got.names == want.names == ["k", "v", "j", "g"]
    np.testing.assert_array_equal(got.to_numpy()[0], want.to_numpy()[0])


def test_public_ops_on_card_match_cpu(cuda):
    """chip_smoke's phase 12 at 2^16 facts over 2^12 keys: the entry step,
    the join ops, kernel C's entry points and the sort ops on batches built
    with no device argument, each launching its kernels, running no plain
    version on the card and equal to the CPU plain result and its
    oracle."""
    import chip_smoke
    import harkdb_tpu_torch as H

    chip_smoke.phase_public_ops(torch, H, _counters(), n=1 << 16,
                                n_keys=1 << 12)


@pytest.mark.parametrize("cls", ["word32", "word40", "two_words"])
@pytest.mark.parametrize("n", [0, 1, 4095, 4097, (1 << 20) + 3, 1 << 25])
def test_pair_sort_on_card_equals_plain_twin(cuda, n, cls):
    """The library's radix pair sort (``kernels/radix_sort.sort_pairs``)
    against its plain twin on the CPU, bit for bit in sorted words and
    values: one 32-bit word, one 40-bit word, and two words through
    ``lexsort_permutation``."""
    import chip_smoke
    from harkdb_tpu_torch.ops import sort as S

    chip_smoke.check_pair_sort(torch, S, cuda, n, cls, seed=n + 7)


def test_lexsort_on_card_never_calls_torch_sort(cuda, monkeypatch):
    """On a CUDA tensor every word goes through the library's pair sort;
    ``torch.sort`` (the plain twin's) is never called."""
    from harkdb_tpu_torch.kernels import radix_sort as R
    from harkdb_tpu_torch.ops import sort as S

    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    k = torch.randint(-2**31, 2**31, (5000,), dtype=torch.int32,
                      device=cuda, generator=g)
    f = k.to(torch.float32)
    flag = k > 0
    wide = k.to(torch.int64) << 20

    def refuse(*args, **kw):
        raise AssertionError("torch.sort ran on the card's sort path")

    monkeypatch.setattr(torch, "sort", refuse)
    before = R.LAUNCHES
    for keys in ([k], [flag, k], [f], [wide], [k, k], [flag, f, wide]):
        perm = S.lexsort_permutation(keys)
        assert perm.dtype == torch.int32 and perm.is_cuda
    S.lexsort_permutation([k], torch.arange(5000, dtype=torch.int32,
                                            device=cuda))
    assert R.LAUNCHES - before == 1 + 1 + 1 + 1 + 2 + 2 + 1


def test_join_ranges_on_card_match_cpu(cuda):
    """``compute_join_ranges`` at a fact-to-dimension shape (2^24 facts,
    some without a dimension, against 2^20 dimension keys, both sides
    below capacity), with and without NULL codes (the 40-bit word, and the
    FULL OUTER fields), on the card equals the CPU's, field by field."""
    from harkdb_tpu_torch.ops import join as J

    rng = np.random.default_rng(11)
    n_f, n_d = 1 << 24, 1 << 20
    fk = rng.integers(0, n_d + 4096, n_f).astype(np.int32)
    dk = rng.permutation(n_d).astype(np.int32)
    n_l, n_r = n_f - 1000, n_d - 100
    for nulls in (False, True):
        l_null = rng.random(n_f) < 0.05 if nulls else None
        r_null = rng.random(n_d) < 0.05 if nulls else None

        def ranges(dev):
            def t(a):
                return None if a is None else torch.from_numpy(a).to(dev)
            return J.compute_join_ranges(
                t(fk), torch.tensor(n_l, dtype=torch.int32, device=dev),
                t(dk), torch.tensor(n_r, dtype=torch.int32, device=dev),
                l_null=t(l_null), r_null=t(r_null), need_full=nulls)

        got, want = ranges(cuda), ranges("cpu")
        n_lefts = int(want.n_lefts)
        assert int(got.n_lefts) == n_lefts == n_l
        for name in ("total", "total_left", "total_approx"):
            assert torch.equal(getattr(got, name).cpu(),
                               getattr(want, name)), name
        for name in ("l_orig", "counts", "lo"):
            assert torch.equal(getattr(got, name)[:n_lefts].cpu(),
                               getattr(want, name)[:n_lefts]), name
        assert torch.equal(got.r_orig[:n_r].cpu(), want.r_orig[:n_r])
        if nulls:
            assert torch.equal(got.total_full.cpu(), want.total_full)
            assert torch.equal(got.r_matched.cpu(), want.r_matched)


def test_sort_counters_on_card_give_32_bits_a_join_row(cuda):
    """A join on one int32 key sorts its rows over 32 bits: the query's
    ``sort_row_bits`` is 32 times its ``sort_rows``."""
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(9)
    ctx = H.Context(device=cuda)
    ctx.create_table("f", {"k": rng.integers(0, 500, 100_000).astype(np.int32),
                           "v": rng.integers(0, 9, 100_000).astype(np.int32)})
    ctx.create_table("d", {"j": np.arange(512, dtype=np.int32),
                           "g": rng.integers(0, 9, 512).astype(np.int32)})
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    m = ctx.last_metrics
    assert m.sort_rows >= 100_000 + 512
    assert m.sort_row_bits == 32 * m.sort_rows


def _join_runs_edges():
    import chip_smoke

    return chip_smoke.JOIN_RUNS_EDGES


@pytest.mark.parametrize("case", range(11), ids=[
    "0+1", "1+0", "2047", "2049", "4097+0", "nulls", "no_live_rows_nulls",
    "runs_over_many_tiles", "half_live_nulls", "cross_join_65536sq",
    "120M+2557"])
def test_join_kernels_on_card_equal_plain_versions(cuda, case):
    """The join's words and runs kernels (``kernels/join_runs.py``) against
    their plain versions on the CPU, bit for bit (``total_approx`` within
    1e-5 relative): lengths around the 2048-row tiles, an empty side, runs
    over many tiles, NULL codes, the whole array one run (the 65536² CROSS
    JOIN: ``total`` and ``total_left`` wrap to 0, ``total_approx`` is
    2^32), and 120M + 2,557 rows."""
    import chip_smoke

    edges = _join_runs_edges()
    assert len(edges) == 11
    nl, nr, n_l, n_r, span, nulls = edges[case]
    totals = chip_smoke.check_join_runs(torch, cuda, nl, nr, n_l, n_r, span,
                                        nulls, seed=1400 + case)
    if span == 1:
        assert totals["total"] == totals["total_left"] == 0
        assert totals["total_approx"] == pytest.approx(2.0 ** 32, rel=1e-5)


def test_join_kernels_never_take_plain_version(cuda, monkeypatch):
    """On CUDA tensors the join's count phase launches the two kernels
    once each and runs neither plain version, with and without NULL codes;
    a two-key join keeps the composition (kernels A and B)."""
    from harkdb_tpu_torch.kernels import join_runs as K
    from harkdb_tpu_torch.ops import join as J

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(K, "join_words_reference", refuse)
    monkeypatch.setattr(K, "join_runs_reference", refuse)
    k = torch.arange(5000, dtype=torch.int32, device=cuda) % 97
    nv = torch.full((), 4900, dtype=torch.int32, device=cuda)
    before = (K.WORDS_LAUNCHES, K.RUNS_LAUNCHES)
    J.compute_join_ranges(k, nv, k[:300], nv)
    J.compute_join_ranges(k, nv, k[:300], nv, l_null=k > 90)
    J.compute_join_ranges([k, k], nv, [k[:300], k[:300]], nv)
    assert (K.WORDS_LAUNCHES, K.RUNS_LAUNCHES) == (before[0] + 2,
                                                   before[1] + 2)


def test_join_counters_on_card_count_fused_rows(cuda):
    """A join on one int32 key runs its count phase in the kernels: the
    query's ``join_fused_rows`` equals its ``join_rows``; a join on two keys
    counts its rows but none fused."""
    import harkdb_tpu_torch as H

    rng = np.random.default_rng(9)
    ctx = H.Context(device=cuda)
    ctx.create_table("f", {"k": rng.integers(0, 500, 100_000).astype(np.int32),
                           "v": rng.integers(0, 9, 100_000).astype(np.int32)})
    ctx.create_table("d", {"j": np.arange(512, dtype=np.int32),
                           "g": rng.integers(0, 9, 512).astype(np.int32)})
    ctx.sql("select f.v, d.g from f join d on f.k = d.j")
    m = ctx.last_metrics
    assert m.join_rows >= 100_000 + 512
    assert m.join_fused_rows == m.join_rows
    ctx.sql("select f.v, d.g from f join d on f.k = d.j and f.v = d.g")
    m = ctx.last_metrics
    assert m.join_rows >= 100_000 + 512 and m.join_fused_rows == 0
