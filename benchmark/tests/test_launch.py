"""Rehearsal of a cell on several cards, on the CPU: four gloo ranks,
each with the cell's tables at a small scale, run the closed loop through
``Context(mesh=...)`` together; rank 0's answers equal the reference and
every rank's equal rank 0's. (On the CPU the window holds a few queries,
so the test asks for no template to be missing.)"""

import time

import pytest

from conftest import cell_entry
from harness.launch import run_ranks


@pytest.mark.parametrize("cell,scale", [("ssb-sf20.flights", 0.0003),
                                        ("tpch-sf10.power", 0.0005)])
def test_four_gloo_ranks_run_a_cell(cell, scale):
    r = run_ranks(cell_entry(cell), 31, 6.0, False, 4, time.perf_counter(),
                  device="cpu", backend="gloo", scale=scale)
    # gloo on the CPU runs a few queries in the window, not every template
    assert r.attempted >= 2 and r.failed == 0, r
    assert r.checks["wrong_answers"] == 0, (r.checks, r.diffs)
