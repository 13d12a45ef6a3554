"""The port's trace spans and its per-query metrics (``utils/metrics.py``),
on the CPU, with one case on the card (marker ``gpu``).

* Under ``torch.profiler`` a query records ``hark.*`` ranges nested as
  README's span table says: ``hark.filter`` per pushed-down WHERE,
  ``hark.join`` per join step with one ``hark.join.count`` (holding one
  ``hark.join.count.sort``) and one ``hark.join.fill`` (holding one
  ``hark.join.fill.gather``),
  ``hark.groupby``, ``hark.tail``, ``hark.result``.
* Every blocking host read of a query lies inside a ``hark.sync.<site>``
  range: each ``aten::item`` the profiler records, and, since ``tolist``
  and ``cpu`` record none on the CPU, each read method of ``torch.Tensor``
  called while the query runs (the CPU's stand-in for the card's
  synchronisations, which the ``gpu`` case checks in the trace itself).
* With no profiler active no ``record_function`` is made, and the spans
  are one shared null context.
* ``QueryMetrics``: ``sql_batch`` reads nothing back for it (``rows_out``
  -1), ``sql`` / ``sql_df`` count the returned rows, the JSON line is
  built only when its level is logged.
* ``hark.window`` opens around each window computation, inside
  ``hark.tail``; ``hark.setop`` around the combination of a set
  operation's arms, whose own operators run outside it; neither opens
  without a profiler. ``window_rows`` and ``setop_rows`` count the rows
  into them.

Run the ``gpu`` case on a card with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m gpu
"""

import contextlib
import logging
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import harkdb_tpu_torch as H
from harkdb_tpu_torch.columnar.batch import ColumnBatch
from harkdb_tpu_torch.plan.planner import QueryPlan
from harkdb_tpu_torch.utils import metrics
from harkdb_tpu_torch.utils.metrics import QueryMetrics, StageTimer

STAR = ("select g, h, sum(v) as s, count(*) as n from f join a on k = ak "
        "join b on d = bk where v > 0 and h < 2 group by g, h "
        "order by s desc")
PROBE = ("select g, sum(v) as s from f join a on k = ak group by g "
         "order by g")

#: queries with the host-read sites each must pass through
SITES = {
    STAR: {"join_guard", "join_total", "n_groups", "result"},
    PROBE: {"join_guard", "join_total", "probe", "n_groups", "result"},
    "select k, v from f where v > 900 order by v desc, k":
        {"where_shrink", "result"},
    "select k from f where v > (select avg(v) from f) and k < 3":
        {"subquery", "result"},
    "select x, count(*) as c from (select k as x from f where v < 0) t "
    "group by x order by c desc, x limit 5": {"n_groups", "result"},
    "select ak from a union select bk from b": {"union", "result"},
    "select sk, length(name) as l from s where sk < 5 order by sk":
        {"upload", "where_shrink", "result"},
}

READS = ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
         "__bool__", "__index__")


def tables(device="cpu"):
    rng = np.random.default_rng(7)
    n = 4000
    c = H.Context(device=device, config=H.EngineConfig(shrink_rows_min=1))
    c.create_table("f", {"k": rng.integers(0, 50, n).astype(np.int32),
                         "d": rng.integers(0, 20, n).astype(np.int32),
                         "v": rng.integers(-1000, 1000, n).astype(np.int32)})
    c.create_table("a", {"ak": np.arange(50, dtype=np.int32),
                         "g": (np.arange(50) % 7).astype(np.int32)})
    c.create_table("b", {"bk": np.arange(20, dtype=np.int32),
                         "h": (np.arange(20) % 3).astype(np.int32)})
    names = np.array(["abc", "abd", "xyz", "aaa", "abz"] * 10, dtype=object)
    c.create_table("s", {"sk": np.arange(50, dtype=np.int32), "name": names})
    return c


@pytest.fixture
def ctx():
    return tables()


def hark_events(prof, *keep):
    """(event, names of its ``hark.*`` ancestors and of those named in
    ``keep``, innermost first) of every event the profiler recorded."""
    out = []
    for e in prof.events():
        chain = []
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("hark.") or p.name in keep:
                chain.append(p.name)
            p = p.cpu_parent
        out.append((e, chain))
    return out


def profiled(ctx, sql):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = ctx.sql(sql)
    return out, hark_events(prof)


def test_spans_nest_as_the_span_table_says(ctx):
    ctx.sql(STAR)                       # plan it: the traced run hits
    out, events = profiled(ctx, STAR)
    np.testing.assert_array_equal(out, tables().sql(STAR))
    hark = [(e.name, chain[0] if chain else None) for e, chain in events
            if e.name.startswith("hark.")]
    names = [n for n, _p in hark]
    assert names.count("hark.join") == 2
    for child in ("hark.join.count", "hark.join.fill"):
        assert [p for n, p in hark if n == child] == ["hark.join"] * 2
    assert ([p for n, p in hark if n == "hark.join.fill.gather"]
            == ["hark.join.fill"] * 2)
    assert ([p for n, p in hark if n == "hark.join.count.sort"]
            == ["hark.join.count"] * 2)
    for site in ("hark.sync.join_guard", "hark.sync.join_total"):
        assert [p for n, p in hark if n == site] == ["hark.join.count"] * 2
    # f's and b's pushed-down WHERE, each under no other operator
    assert [p for n, p in hark if n == "hark.filter"] == [None, None]
    assert names.count("hark.load") == 3
    assert ("hark.sync.n_groups", "hark.groupby") in hark
    assert names.count("hark.tail") == 1
    assert ("hark.sync.result", "hark.result") in hark
    assert ("hark.plan", None) in hark and "hark.parse" not in names
    assert names[-2:] == ["hark.result", "hark.sync.result"]
    starts = {n: e.time_range.start for (e, _c), n in zip(
        [x for x in events if x[0].name.startswith("hark.")], names)}
    assert (starts["hark.filter"] < starts["hark.join"]
            < starts["hark.groupby"] < starts["hark.tail"]
            < starts["hark.result"])


def test_a_plan_cache_miss_records_parse_and_the_probe(ctx):
    _out, events = profiled(ctx, PROBE)
    hark = [(e.name, chain[0] if chain else None) for e, chain in events
            if e.name.startswith("hark.")]
    assert ("hark.parse", "hark.plan") in hark
    assert ("hark.sync.probe", "hark.groupby") in hark


@pytest.mark.parametrize("sql", sorted(SITES))
def test_every_aten_item_lies_inside_a_sync_span(ctx, sql):
    ctx.sql(sql)
    _out, events = profiled(ctx, sql)
    items = [chain for e, chain in events if e.name == "aten::item"]
    assert items
    assert all(any(n.startswith("hark.sync.") for n in chain)
               for chain in items), items


@pytest.mark.parametrize("sql", sorted(SITES))
def test_every_host_read_goes_through_host_read(ctx, monkeypatch, sql):
    """``host_read`` is replaced in every module of the port by a counting
    version, and ``torch.Tensor``'s read methods by versions that note a
    call made while no ``host_read`` is open: a plan run twice (the
    first execution probes and resolves) makes every read inside one, at
    the sites its query needs."""
    depth = [0]
    sites = []
    stray = []
    real = metrics.host_read

    @contextlib.contextmanager
    def counting(site):
        sites.append(site)
        depth[0] += 1
        try:
            with real(site):
                yield
        finally:
            depth[0] -= 1

    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("harkdb_tpu_torch")
                and getattr(mod, "host_read", None) is real):
            monkeypatch.setattr(mod, "host_read", counting)

    def noting(name, fn):
        def read(self, *a, **kw):
            if depth[0] == 0:
                stray.append(name)
            return fn(self, *a, **kw)
        return read

    for name in READS:
        fn = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, noting(name, fn))
    try:
        for _ in range(2):
            ctx.sql(sql)
    finally:
        monkeypatch.undo()
    assert not stray, stray
    assert set(sites) == SITES[sql]


def test_no_record_function_without_a_profiler(ctx, monkeypatch):
    want = ctx.sql(STAR)

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    np.testing.assert_array_equal(tables().sql(STAR), want)
    np.testing.assert_array_equal(ctx.sql(STAR), want)
    assert metrics.span("hark.a") is metrics.span("hark.b")
    assert metrics.span("hark.a") is metrics.host_read("result")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            metrics.span("hark.a")


WINDOW = ("select g, sum(v) as s, sum(sum(v)) over () "
          "as t, rank() over (order by sum(v)) as r from f join a on "
          "k = ak group by g order by g")
SETOP = ("select k from f where v > 500 intersect select ak from a "
         "except select bk from b")


def test_window_and_setop_spans_open_where_the_work_runs(ctx):
    _out, events = profiled(ctx, WINDOW)
    win = [chain for e, chain in events if e.name == "hark.window"]
    assert win == [["hark.tail"]]
    _out, events = profiled(ctx, SETOP)
    setops = [chain for e, chain in events if e.name == "hark.setop"]
    assert len(setops) == 4 and all(c == [] for c in setops)
    # the arms' own operators run outside it, the combination's reads in it
    filters = [chain for e, chain in events if e.name == "hark.filter"]
    assert filters and all("hark.setop" not in c for c in filters)
    reads = [chain for e, chain in events if e.name == "hark.sync.union"]
    assert len(reads) == 5 and all(c[:1] == ["hark.setop"] for c in reads)


@pytest.mark.parametrize("sql", [WINDOW, SETOP])
def test_window_and_setop_spans_cost_nothing_without_a_profiler(
        ctx, monkeypatch, sql):
    want = ctx.sql(sql)

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    np.testing.assert_array_equal(ctx.sql(sql), want)
    assert metrics.window(0) is metrics.span("hark.a")


def test_window_rows_and_setop_rows_count_the_rows(ctx):
    out = ctx.sql(WINDOW)
    m = ctx.last_metrics
    # one window computation over the grouped batch: 7 groups, padded
    assert out.shape[0] == 7 and 7 <= m.window_rows < 7 + 1024
    assert m.setop_rows == 0
    ctx.sql(SETOP)
    m = ctx.last_metrics
    n_f = int((ctx.sql("select count(*) from f where v > 500"))[0, 0])
    assert m.setop_rows == n_f + 50 + 20 and m.window_rows == 0
    ctx.sql(STAR)
    assert ctx.last_metrics.window_rows == ctx.last_metrics.setop_rows == 0


def test_stage_timer_records_its_interval_as_a_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with StageTimer("hark.plan") as t:
            torch.ones(4).sum()
    assert t.ms > 0
    assert [e.name for e in prof.events()].count("hark.plan") == 1
    with StageTimer() as t2:
        pass
    assert t2.ms >= 0


class _Unread:
    """A count that fails if anything reads it back."""

    def _refuse(self, *a, **kw):
        raise AssertionError("the result's count was read back")

    __int__ = __index__ = __float__ = __bool__ = item = tolist = cpu = _refuse


def test_sql_batch_reads_nothing_back_for_its_metrics(ctx, monkeypatch):
    execute = QueryPlan.execute

    def unread(self, tables):
        out = execute(self, tables)
        return ColumnBatch(out.columns, _Unread())

    monkeypatch.setattr(QueryPlan, "execute", unread)
    batch, names = ctx.sql_batch(STAR)
    assert isinstance(batch.n_valid, _Unread)
    assert names == ["g", "h", "s", "n"]
    m = ctx.last_metrics
    assert m.rows_out == -1 and m.execute_ms > 0 and m.plan_ms > 0


def test_sql_and_sql_df_count_the_rows_they_return(ctx):
    out = ctx.sql(STAR)
    m = ctx.last_metrics
    assert m.rows_out == out.shape[0] > 1 and m.cached_plan is False
    assert m.execute_ms > 0
    df = ctx.sql_df(STAR)
    m = ctx.last_metrics
    assert m.rows_out == len(df) == out.shape[0] and m.cached_plan
    np.testing.assert_array_equal(df.to_numpy(), out)
    none = tables()
    none.config = none.config.replace(collect_metrics=False)
    none.sql(STAR)
    assert none.last_metrics.rows_out == -1


def test_the_log_line_is_built_only_when_logged(ctx, monkeypatch, caplog):
    built = []
    to_json = QueryMetrics.to_json

    def counting(self):
        built.append(self.sql)
        return to_json(self)

    monkeypatch.setattr(QueryMetrics, "to_json", counting)
    caplog.set_level(logging.WARNING, logger="harkdb_tpu_torch")
    ctx.sql(STAR)
    ctx.sql_batch(STAR)
    assert built == []
    caplog.set_level(logging.INFO, logger="harkdb_tpu_torch")
    ctx.sql(STAR)
    assert built == [STAR]
    assert any('"rows_out"' in r.getMessage() for r in caplog.records)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device: the card's runtime calls "
                    "are traced there")


@pytest.mark.gpu
@pytest.mark.parametrize("sql", [STAR, PROBE])
def test_every_card_sync_lies_inside_a_sync_span(cuda, sql):
    """On the card: every stream, device or event synchronisation and
    blocking copy the query's runtime calls make lies inside a
    ``hark.sync.*`` range, and the device time of every kernel, copy and
    set is enqueued inside an operator span."""
    c = tables("cuda")
    want = tables().sql(sql)
    c.sql(sql)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("test.query"):
            got = c.sql(sql)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    syncs = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D")
    # the profiler's own synchronisations lie outside the query's range
    events = [(e, chain) for e, chain in hark_events(prof, "test.query")
              if "test.query" in chain]
    found = [chain for e, chain in events if e.name in syncs]
    assert found
    assert all(any(n.startswith("hark.sync.") for n in chain)
               for chain in found), found
    launches = [chain for e, chain in events
                if e.name.startswith(("cudaLaunchKernel", "cudaMemcpyAsync",
                                      "cudaMemsetAsync"))]
    assert launches
    assert all(any(n.startswith("hark.") and not n.startswith("hark.sync.")
                   for n in chain) for chain in launches)
