"""The ``join_fused_share`` reader (``metrics/join_fused_share.py``) on
hand-built traces: the row-weighted share of the joins' count-phase rows
that ran in the hand-written kernels, and None for a program whose metrics
lack the counters or a window that joined nothing."""

import types

import pytest

from harness import registry
from harness.trace import Trace


def read(metrics):
    t = Trace(templates=["q"] * len(metrics), query_metrics=metrics)
    return registry.metric_reader("join_fused_share").read(t)


def joined(rows, fused):
    return types.SimpleNamespace(join_rows=rows, join_fused_rows=fused)


def test_join_fused_share_is_row_weighted():
    # a 120M-row join in the kernels, a two-key join of 2M rows outside
    # them, a query with no join
    q = [joined(120_002_557, 120_002_557), joined(2_000_000, 0),
         joined(0, 0)]
    assert read(q) == pytest.approx(100 * 120_002_557 / 122_002_557)
    assert read([joined(10, 10), joined(30, 30)]) == pytest.approx(100.0)
    assert read([joined(10, 0)]) == 0.0


def test_join_fused_share_is_none_without_the_counters():
    """A program whose metrics have no ``join_rows`` (the parent), a trace
    without metrics, or a window that joined nothing."""
    assert read([types.SimpleNamespace(sort_rows=5)]) is None
    assert read([None, None]) is None
    assert read([]) is None
    assert read([joined(0, 0)]) is None
