"""The span readers (``harness/spans.py``, ``metrics/join_ms.py`` and the
others) on hand-built traces: device ops put down to the innermost
operator span through their runtime call's correlation id, a read's copy
left to the operator that read, the idle-after-read gap rule, and None for
a trace without the port's spans."""

import pytest

from harness import registry
from harness.spans import innermost, operator_ns
from harness.trace import Span, Trace


def trace(host_ops, runtime, device, n_queries=1, window=(0, 1000)):
    t = Trace(templates=["q"] * n_queries, query_metrics=[None] * n_queries)
    t.host_ops, t.runtime, t.device = host_ops, runtime, device
    t.window = window
    return t


def read(name, t):
    return registry.metric_reader(name).read(t)


def star_join_trace():
    """One query: a filter, then a join step whose count phase reads the
    total back (a copy inside ``hark.sync.join_total``), then a group-by;
    one kernel launched between spans."""
    host = [
        Span("hark.filter", 0, 100),
        Span("aten::where", 10, 20),
        Span("hark.join", 100, 500),
        Span("hark.join.count", 110, 300),
        Span("hark.sync.join_total", 250, 300),
        Span("hark.join.fill", 300, 490),
        Span("hark.groupby", 600, 700),
    ]
    runtime = [
        Span("cudaLaunchKernel", 12, 14, corr=1),        # filter
        Span("cudaLaunchKernel", 120, 122, corr=2),      # count
        Span("cudaMemcpyAsync", 255, 258, corr=3),       # the total's copy
        Span("cudaStreamSynchronize", 258, 290, corr=4),
        Span("cudaLaunchKernel", 310, 312, corr=5),      # fill
        Span("cudaLaunchKernel", 550, 552, corr=6),      # no operator
        Span("cudaLaunchKernel", 610, 612, corr=7),      # group-by
    ]
    device = [
        Span("compact_kernel", 20, 60, corr=1),
        Span("RadixSortOnesweep", 130, 250, corr=2),
        Span("Memcpy DtoH", 260, 262, corr=3),
        Span("index_elementwise_kernel", 320, 420, corr=5),
        Span("arange", 560, 570, corr=6),
        Span("dense_agg_kernel", 620, 650, corr=7),
    ]
    return trace(host, runtime, device)


def test_innermost_takes_the_deepest_open_span():
    spans = [Span("a", 0, 100), Span("b", 10, 50), Span("c", 20, 30),
             Span("d", 60, 90)]
    got = innermost(spans, [5, 25, 40, 55, 70, 100, 150])
    assert [s.name if s else None for s in got] == [
        "a", "c", "b", "a", "d", "a", None]


def test_device_time_goes_to_the_innermost_operator_by_correlation():
    by_op = operator_ns(star_join_trace())
    assert by_op == {"hark.filter": 40, "hark.join.count": 122,
                     "hark.join.fill": 100, None: 10, "hark.groupby": 30}


def test_a_read_inside_a_join_leaves_its_copy_to_join_ms():
    t = star_join_trace()
    # sort 120 + the total's copy 2 + gathers 100, in ms per query
    assert read("join_ms", t) == pytest.approx(222 / 1e6)
    assert read("filter_ms", t) == pytest.approx(40 / 1e6)
    assert read("groupby_ms", t) == pytest.approx(30 / 1e6)


def test_per_query_divides_by_the_window_queries():
    t = star_join_trace()
    t.templates = ["q1", "q2"]
    t.query_metrics = [None, None]
    assert read("join_ms", t) == pytest.approx(111 / 1e6)


def test_a_device_op_with_no_runtime_call_is_unattributed():
    t = star_join_trace()
    t.device.append(Span("Memset", 700, 720, corr=99))
    assert operator_ns(t)[None] == 30


def test_sync_idle_counts_gaps_that_open_inside_a_read():
    """Busy [20, 60), [130, 250), [260, 262), [320, 420), [560, 570),
    [620, 650) in a window [0, 1000): the gap opening at 262, inside
    ``hark.sync.join_total`` (250-300), counts until 320; the gap opening
    at 250, when the read had just begun, counts too (250 is inside);
    gaps that open at 60, 420, 570 and 650 are outside every read."""
    t = star_join_trace()
    assert read("sync_idle_ms", t) == pytest.approx((260 - 250 + 320 - 262)
                                                    / 1e6)


def test_a_gap_opening_after_the_read_is_not_counted():
    t = trace([Span("hark.join", 0, 400),
               Span("hark.sync.join_total", 100, 150)],
              [Span("cudaLaunchKernel", 10, 12, corr=1),
               Span("cudaLaunchKernel", 160, 162, corr=2)],
              [Span("k1", 20, 90, corr=1), Span("k2", 170, 200, corr=2)],
              window=(0, 300))
    # gaps: [0, 20) before any read, [90, 170) opens before the read began,
    # [200, 300) after it ended
    assert read("sync_idle_ms", t) == 0.0
    t.host_ops.append(Span("hark.sync.result", 195, 260))
    assert read("sync_idle_ms", t) == pytest.approx(100 / 1e6)


@pytest.mark.parametrize("name", ["join_ms", "groupby_ms", "filter_ms",
                                  "sync_idle_ms"])
def test_none_without_the_ports_spans(name):
    t = star_join_trace()
    t.host_ops = [s for s in t.host_ops if not s.name.startswith("hark.")]
    assert read(name, t) is None
    t = star_join_trace()
    t.templates, t.query_metrics = [], []
    assert read(name, t) is None
