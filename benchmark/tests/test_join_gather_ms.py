"""The ``join_gather_ms`` reader (``metrics/join_gather_ms.py``) on
hand-built traces: the device time launched inside the port's
``hark.join.fill.gather`` spans, kept inside ``join_ms``, and None for a
trace without that span."""

import pytest

from harness import registry
from harness.spans import operator_ns
from harness.trace import Span, Trace


def read(name, t):
    return registry.metric_reader(name).read(t)


def gather_trace():
    """One query: a join step whose count phase sorts, whose fill launches
    100 ns of gathers, and whose ``hark.join.fill.gather`` span launches
    60 ns more."""
    host = [
        Span("hark.join", 100, 500),
        Span("hark.join.count", 110, 300),
        Span("hark.join.fill", 300, 490),
        Span("hark.join.fill.gather", 400, 480),
    ]
    runtime = [
        Span("cudaLaunchKernel", 120, 122, corr=1),      # count
        Span("cudaLaunchKernel", 310, 312, corr=2),      # fill
        Span("cudaLaunchKernel", 410, 412, corr=3),      # fill's gathers
    ]
    device = [
        Span("RadixSortOnesweep", 130, 250, corr=1),
        Span("index_elementwise_kernel", 320, 420, corr=2),
        Span("index_elementwise_kernel", 425, 485, corr=3),
    ]
    t = Trace(templates=["q"], query_metrics=[None])
    t.host_ops, t.runtime, t.device = host, runtime, device
    t.window = (0, 1000)
    return t


def test_join_gather_ms_reads_the_fill_gather_span():
    t = gather_trace()
    assert read("join_gather_ms", t) == pytest.approx(60 / 1e6)
    # the gathers stay inside join_ms: sort 120 + fill 100 + gathers 60
    assert read("join_ms", t) == pytest.approx(280 / 1e6)
    assert operator_ns(t)["hark.join.fill"] == 100
    assert operator_ns(t)["hark.join.fill.gather"] == 60


def test_join_gather_ms_is_none_without_its_span():
    """None on a trace with no ``hark.`` range, and on one whose program
    opens the other spans but not this one (a parent without it)."""
    t = gather_trace()
    t.host_ops = [s for s in t.host_ops if s.name != "hark.join.fill.gather"]
    assert read("join_gather_ms", t) is None
    t.host_ops = []
    assert read("join_gather_ms", t) is None
