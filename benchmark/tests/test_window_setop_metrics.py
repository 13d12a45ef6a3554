"""The ``window_ms``, ``setop_ms`` and ``window_rows`` readers on
hand-built traces (device time enqueued inside ``hark.window`` /
``hark.setop``, None for a program without the spans or the counter), and
a traced run of ``tpcds-sf10.channels`` on the CPU that reads all three,
and the join and inner-plan metrics whose lists name the cell."""

import time
from types import SimpleNamespace

import pytest

from conftest import cell_entry
from harness import registry
from harness.cell import run_cell
from harness.trace import Span, Trace


def read(name, t):
    return registry.metric_reader(name).read(t)


def window_trace(n_queries=1):
    """One query: a group-by, then inside ``hark.tail`` a window (a sort
    and a scan) and a set operation's combination (a sort and a read)."""
    host = [
        Span("hark.groupby", 100, 200),
        Span("hark.tail", 300, 600),
        Span("hark.window", 310, 400),
        Span("hark.setop", 420, 500),
        Span("hark.sync.union", 450, 480),
    ]
    runtime = [
        Span("cudaLaunchKernel", 110, 112, corr=1),
        Span("cudaLaunchKernel", 320, 322, corr=2),
        Span("cudaLaunchKernel", 330, 332, corr=3),
        Span("cudaLaunchKernel", 430, 432, corr=4),
        Span("cudaMemcpyAsync", 452, 454, corr=5),
        Span("cudaLaunchKernel", 550, 552, corr=6),
    ]
    device = [
        Span("RadixSortOnesweep", 113, 153, corr=1),
        Span("RadixSortOnesweep", 323, 353, corr=2),
        Span("segscan_kernel", 333, 343, corr=3),
        Span("RadixSortOnesweep", 433, 453, corr=4),
        Span("Memcpy DtoH", 455, 457, corr=5),
        Span("elementwise", 553, 563, corr=6),
    ]
    metrics = [SimpleNamespace(window_rows=1000 * (i + 1))
               for i in range(n_queries)]
    t = Trace(templates=["q"] * n_queries, query_metrics=metrics)
    t.host_ops, t.runtime, t.device = host, runtime, device
    t.window = (0, 1000)
    return t


def test_window_and_setop_ms_read_their_spans():
    t = window_trace()
    assert read("window_ms", t) == pytest.approx(40 / 1e6)
    # the read's copy stays with the operator that read it
    assert read("setop_ms", t) == pytest.approx(22 / 1e6)
    t = window_trace(n_queries=2)
    assert read("window_ms", t) == pytest.approx(20 / 1e6)
    assert read("window_rows", t) == 1500


def test_readers_are_none_for_a_program_without_them():
    t = window_trace()
    t.host_ops = [s for s in t.host_ops
                  if s.name not in ("hark.window", "hark.setop")]
    assert read("window_ms", t) is None and read("setop_ms", t) is None
    t.query_metrics = [SimpleNamespace(held_bytes=0)]
    assert read("window_rows", t) is None


def test_a_traced_channels_run_reads_all_three():
    r = run_cell(cell_entry("tpcds-sf10.channels"), 2**31 + 23, 1.0, True,
                 time.perf_counter(), device="cpu", scale=0.001)
    assert r.correct and r.failed == 0, (r.checks, r.errors, r.diffs)
    assert r.per_layer["window_ms"] == 0.0      # no device ops on the CPU
    assert r.per_layer["setop_ms"] == 0.0
    assert r.per_layer["window_rows"] > 0
    for name in ("subquery_ms", "join_runs_ms", "join_gather_ms",
                 "join_fused_share"):
        assert name in r.per_layer, name
