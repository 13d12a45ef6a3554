"""The ``subquery_ms`` reader (``metrics/subquery_ms.py``) on hand-built
traces: the device time launched anywhere inside the port's
``hark.subquery`` spans, the operators nested in them and nested inner
plans counted once, and None for a trace in which no inner plan ran; and on
the CPU, a traced run of ``tpch-sf10.power`` whose derived tables and
subqueries run on every query of their templates."""

import time

import pytest

from conftest import cell_entry
from harness import registry
from harness.cell import run_cell
from harness.trace import Span, Trace


def read(t):
    return registry.metric_reader("subquery_ms").read(t)


def nested_trace(n_queries=1):
    """One query: a derived table's inner plan (a filter and a group-by,
    with a nested inner plan's filter) inside ``hark.subquery``, its
    result's read back, then the outer join outside it."""
    host = [
        Span("hark.subquery", 100, 400),
        Span("hark.filter", 110, 150),
        Span("hark.subquery", 160, 250),
        Span("hark.filter", 170, 240),
        Span("hark.groupby", 260, 350),
        Span("hark.sync.subquery", 360, 390),
        Span("hark.join", 500, 700),
    ]
    runtime = [
        Span("cudaLaunchKernel", 112, 114, corr=1),      # inner filter
        Span("cudaLaunchKernel", 172, 174, corr=2),      # nested filter
        Span("cudaLaunchKernel", 262, 264, corr=3),      # inner group-by
        Span("cudaMemcpyAsync", 362, 364, corr=4),       # the read's copy
        Span("cudaLaunchKernel", 510, 512, corr=5),      # outer join
    ]
    device = [
        Span("compact_kernel", 115, 135, corr=1),
        Span("compact_kernel", 175, 185, corr=2),
        Span("RadixSortOnesweep", 265, 305, corr=3),
        Span("Memcpy DtoH", 365, 367, corr=4),
        Span("RadixSortOnesweep", 515, 615, corr=5),
    ]
    t = Trace(templates=["q"] * n_queries, query_metrics=[None] * n_queries)
    t.host_ops, t.runtime, t.device = host, runtime, device
    t.window = (0, 1000)
    return t


def test_subquery_ms_counts_everything_inside_the_span():
    # filter 20 + nested filter 10 + group-by 40 + the read's copy 2
    assert read(nested_trace()) == pytest.approx(72 / 1e6)
    assert registry.metric_reader("join_ms").read(nested_trace()) == \
        pytest.approx(100 / 1e6)


def test_subquery_ms_per_query():
    assert read(nested_trace(n_queries=4)) == pytest.approx(18 / 1e6)


def test_subquery_ms_is_none_without_an_inner_plan():
    t = nested_trace()
    t.host_ops = [s for s in t.host_ops if s.name != "hark.subquery"]
    assert read(t) is None
    t = nested_trace()
    t.templates, t.query_metrics = [], []
    assert read(t) is None


#: templates of the power mix whose plan runs one inner plan an execution
INNER = {"q4": 1, "q13": 1, "q17": 1, "q18": 1}


def test_inner_plans_run_on_every_query_of_the_power_mix():
    """Every query of Q4 (a derived table), Q13 (a derived table), Q17 (a
    decorrelated subquery) and Q18 (an IN subquery) runs its inner plan,
    first sight of a text or not; the traced run reads ``subquery_ms``
    and, off the card, no ``held_mb``."""
    seen = []

    def answer(ctx, q, _tables):
        out = ctx.sql(q.sql)
        seen.append((q.template, ctx.last_metrics.inner_plans_run,
                     ctx.last_metrics.held_bytes))
        return out

    r = run_cell(cell_entry("tpch-sf10.power"), 2**31 + 18, 3.0, True,
                 time.perf_counter(), device="cpu", scale=0.001,
                 answer=answer)
    assert r.correct and r.failed == 0, (r.checks, r.errors)
    templates = {t for t, _n, _h in seen}
    assert set(INNER) <= templates
    assert all(n == INNER.get(t, 0) for t, n, _h in seen), seen
    assert all(h == -1 for _t, _n, h in seen)
    assert r.per_layer["subquery_ms"] == 0.0      # no device ops on the CPU
    assert "held_mb" not in r.per_layer
