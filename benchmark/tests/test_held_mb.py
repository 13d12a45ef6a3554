"""The ``held_mb`` reader (``metrics/held_mb.py``) on hand-built traces:
the mean of ``Context.last_metrics.held_bytes`` in MiB over the window's
queries, leaving out -1 (a Context off the card), and None for a program
whose metrics lack the counter."""

import types

import pytest

from harness import registry
from harness.trace import Trace


def read(metrics):
    t = Trace(templates=["q"] * len(metrics), query_metrics=metrics)
    return registry.metric_reader("held_mb").read(t)


def held(n):
    return types.SimpleNamespace(held_bytes=n)


def test_held_mb_is_the_mean_in_mib():
    assert read([held(0), held(2 << 20), held(4 << 20)]) == pytest.approx(2)
    assert read([held(512)]) == pytest.approx(512 / 2**20)


def test_held_mb_leaves_out_queries_off_the_card():
    assert read([held(-1), held(6 << 20)]) == pytest.approx(6)
    assert read([held(-1), held(-1)]) is None


def test_held_mb_is_none_without_the_counter():
    """A program whose metrics have no ``held_bytes`` (the parent), or a
    trace without metrics."""
    assert read([types.SimpleNamespace(plan_ms=1.0)]) is None
    assert read([None, None]) is None
    assert read([]) is None
