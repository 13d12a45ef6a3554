"""The ``join_runs_ms`` reader (``metrics/join_runs_ms.py``) on hand-built
traces: the device time launched inside the port's ``hark.join.count``
spans less their ``hark.join.count.sort`` spans, and None for a trace
without the sort's span."""

import pytest

from harness import registry
from harness.trace import Span, Trace


def read(name, t):
    return registry.metric_reader(name).read(t)


def count_trace():
    """Two queries; one join step whose count phase launches 30 ns of
    words, a 100 ns sort inside ``hark.join.count.sort`` and 50 ns of runs,
    and whose fill launches 70 ns."""
    host = [
        Span("hark.join", 100, 600),
        Span("hark.join.count", 110, 400),
        Span("hark.join.count.sort", 200, 300),
        Span("hark.join.fill", 400, 590),
    ]
    runtime = [
        Span("cudaLaunchKernel", 120, 122, corr=1),      # words
        Span("cudaLaunchKernel", 210, 212, corr=2),      # the sort
        Span("cudaLaunchKernel", 310, 312, corr=3),      # runs
        Span("cudaLaunchKernel", 410, 412, corr=4),      # fill
    ]
    device = [
        Span("join_words_kernel", 130, 160, corr=1),
        Span("DeviceRadixSortOnesweepKernel", 220, 320, corr=2),
        Span("join_runs_kernel", 330, 380, corr=3),
        Span("expand_kernel", 420, 490, corr=4),
    ]
    t = Trace(templates=["q1", "q2"], query_metrics=[None, None])
    t.host_ops, t.runtime, t.device = host, runtime, device
    t.window = (0, 1000)
    return t


def test_join_runs_ms_is_the_count_phase_less_its_sort():
    t = count_trace()
    assert read("join_runs_ms", t) == pytest.approx(80 / 1e6 / 2)
    # all of it, the sort too, stays inside join_ms
    assert read("join_ms", t) == pytest.approx(250 / 1e6 / 2)


def test_join_runs_ms_is_none_without_the_sort_span():
    """None on a trace with no ``hark.`` range, and on one whose program
    opens ``hark.join.count`` but not its sort's span (a parent without
    it)."""
    t = count_trace()
    t.host_ops = [s for s in t.host_ops if s.name != "hark.join.count.sort"]
    assert read("join_runs_ms", t) is None
    t.host_ops = []
    assert read("join_runs_ms", t) is None
