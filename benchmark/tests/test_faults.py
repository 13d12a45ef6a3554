"""A run with the timed path broken underneath comes out as not correct:
the control (the reference in float32 sums in the program's place), an
answer altered where it is produced, half of an answer's rows left out,
and a stale answer (the previous query's, as a step that returns its
state unchanged). A sound run of the same size comes out correct."""

import time

import numpy as np
import pytest

from control import control_answer
from conftest import cell_entry
from harness.cell import run_cell

CELLS = {"ssb-sf20.flights": ("ssb", 0.0005),
         "tpch-sf10.power": ("tpch", 0.001)}


def altered(ctx, q, _tables):
    out = np.array(ctx.sql(q.sql), copy=True)
    if out.size:
        out.flat[-1] += 1
    return out


def half(ctx, q, _tables):
    out = ctx.sql(q.sql)
    return out[: out.shape[0] // 2]


def stale():
    last = {}

    def answer(ctx, q, _tables):
        out = ctx.sql(q.sql)
        prev, last["out"] = last.get("out", out), out
        return prev
    return answer


def run(cell, answer):
    _ref, scale = CELLS[cell]
    return run_cell(cell_entry(cell), 4_000_000_017, 1.5, False, time.perf_counter(),
                    device="cpu", scale=scale, answer=answer)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    r = run(cell, None)
    assert r.correct and r.checks["wrong_answers"] == 0, r.diffs
    assert r.attempted >= 13


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["control", "altered", "half", "stale"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    answer = {"control": lambda: control_answer(CELLS[cell][0]),
              "altered": lambda: altered, "half": lambda: half,
              "stale": stale}[fault]()
    r = run(cell, answer)
    assert not r.correct
    assert r.checks["wrong_answers"] > 0
