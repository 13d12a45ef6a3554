"""On a CUDA card: a short run of each cell at a small scale through the
same path as ``run.py``, answers checked against the reference. Skips
without a card (marker ``gpu``)."""

import time

import pytest

from conftest import cell_entry
from harness.cell import run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("cell,scale", [("ssb-sf20.flights", 0.01),
                                        ("tpch-sf10.power", 0.01)])
def test_a_cell_runs_on_the_card(cell, scale):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_cell(cell_entry(cell), 77, 2.0, True, time.perf_counter(), device="cuda",
                 scale=scale)
    assert r.correct, (r.checks, r.diffs)
    assert r.memory_peak_bytes > 0 and r.busy_s > 0
