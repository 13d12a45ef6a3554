"""The ``sort_key_bits`` reader (``metrics/sort_key_bits.py``) on
hand-built traces: the row-weighted mean of the bits each sorted row's
order word covered, over the window's queries, and None for a program
whose metrics lack the counters."""

import types

import pytest

from harness import registry
from harness.trace import Trace


def read(metrics):
    t = Trace(templates=["q"] * len(metrics), query_metrics=metrics)
    return registry.metric_reader("sort_key_bits").read(t)


def sorted_rows(rows, bits):
    return types.SimpleNamespace(sort_rows=rows, sort_row_bits=bits)


def test_sort_key_bits_is_the_row_weighted_mean():
    # a 120M-row join over 32 bits, a group-by of 1000 rows over 33 bits,
    # a query that sorted nothing
    q = [sorted_rows(120_000_000, 32 * 120_000_000),
         sorted_rows(1000, 33 * 1000), sorted_rows(0, 0)]
    assert read(q) == pytest.approx((32 * 120e6 + 33e3) / (120e6 + 1e3))
    assert read([sorted_rows(10, 400), sorted_rows(30, 1320)]) == \
        pytest.approx(43.0)


def test_sort_key_bits_is_none_without_the_counters():
    """A program whose metrics have no ``sort_rows`` (the parent), a trace
    without metrics, or a window that sorted nothing."""
    assert read([types.SimpleNamespace(plan_ms=1.0)]) is None
    assert read([None, None]) is None
    assert read([]) is None
    assert read([sorted_rows(0, 0)]) is None
