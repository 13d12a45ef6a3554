"""Per-query metrics, structured logging, and the port's trace spans.

Fills the observability slot from SURVEY §5 — the reference's entire
observability story is one stray debug print (``parse.py:57``).

* :class:`QueryMetrics`: one record per query, always on: host-side stage
  timings, row count, plan-cache hit (``Context.last_metrics``).
* :func:`span` / :func:`host_read`: named ranges on ``torch.profiler``'s
  own clock, recorded only while a profiler is active. The planner opens
  ``hark.<operator>`` around each operator and ``hark.sync.<site>`` around
  each blocking read of the card's results, so a trace puts every kernel,
  copy and idle gap down to what the host was doing (``Context.profile``
  and ``--profile`` write them; README lists the names).
* :func:`inner_plan`: around each run of an inner plan (a derived table's
  or a subquery's): counts it and opens ``hark.subquery``.
* :func:`count_sort`: the rows and bits of every order word sorted
  (``kernels.radix_sort.sort_pairs``).
* :func:`count_join`: the rows of every join's count phase, and those
  that ran in the hand-written kernels (``kernels.join_runs``).
* :func:`window`: around each window computation (``plan/windows.py``):
  counts its rows and opens ``hark.window``; :func:`count_setop` counts
  the rows of a set operation's arms (``plan/union_plan.py``, which opens
  ``hark.setop`` around their combination).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("harkdb_tpu_torch")

_NO_SPAN = contextlib.nullcontext()

#: Inner plans run in this process (``inner_plan``); ``Context`` takes the
#: difference around a query.
_INNER_PLANS_RUN = 0

#: Rows of every order word sorted in this process, and those rows times the
#: bits each word's sort covered (``count_sort``); ``Context`` takes the
#: differences around a query.
_SORT_ROWS = 0
_SORT_ROW_BITS = 0

#: Rows of every join's count phase in this process, and those whose count
#: phase ran in the hand-written kernels (``count_join``).
_JOIN_ROWS = 0
_JOIN_FUSED_ROWS = 0

#: Rows into window computations and into set operations in this process
#: (``window``, ``count_setop``).
_WINDOW_ROWS = 0
_SETOP_ROWS = 0


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records;
    otherwise one shared null context, so an untraced query pays one flag
    check per span."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_read(site: str):
    """The span ``hark.sync.<site>`` around a blocking read of device values
    to the host (a count, a total, the result's columns): the host waits
    for the card there. Every such read of the single-device path goes
    through here."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function("hark.sync." + site)
    return _NO_SPAN


def inner_plan():
    """The span ``hark.subquery`` around one run of an inner plan: a
    derived table's (FROM subquery, CTE, view, decorrelated subquery) or a
    scalar / IN subquery's. Each runs once per execution of its plan, and
    each run is counted here."""
    global _INNER_PLANS_RUN
    _INNER_PLANS_RUN += 1
    return span("hark.subquery")


def inner_plans_run() -> int:
    """Inner plans run in this process so far."""
    return _INNER_PLANS_RUN


def count_sort(rows: int, bits: int) -> None:
    """Count one sort of ``rows`` order words over ``bits`` bits (host
    ints: no sync)."""
    global _SORT_ROWS, _SORT_ROW_BITS
    _SORT_ROWS += rows
    _SORT_ROW_BITS += rows * bits


def sorts_counted() -> Tuple[int, int]:
    """``(rows, rows x bits)`` of the order words sorted in this process so
    far."""
    return _SORT_ROWS, _SORT_ROW_BITS


def count_join(rows: int, fused: bool) -> None:
    """Count one join's count phase over ``rows`` rows (both sides'
    capacities), ``fused`` where it ran in the hand-written kernels (host
    ints: no sync)."""
    global _JOIN_ROWS, _JOIN_FUSED_ROWS
    _JOIN_ROWS += rows
    _JOIN_FUSED_ROWS += rows if fused else 0


def joins_counted() -> Tuple[int, int]:
    """``(rows, fused rows)`` of the joins' count phases in this process so
    far."""
    return _JOIN_ROWS, _JOIN_FUSED_ROWS


def window(rows: int):
    """The span ``hark.window`` around one window computation (its sorts
    and scans) over a batch of ``rows`` rows, padding included (a host
    int: no sync); the rows are counted."""
    global _WINDOW_ROWS
    _WINDOW_ROWS += rows
    return span("hark.window")


def count_setop(rows: int) -> None:
    """Count one arm's ``rows`` live rows into a set operation (read on
    the host where the combination reads them anyway)."""
    global _SETOP_ROWS
    _SETOP_ROWS += rows


def rows_counted() -> Tuple[int, int]:
    """``(window rows, set-operation rows)`` in this process so far."""
    return _WINDOW_ROWS, _SETOP_ROWS


@dataclasses.dataclass
class QueryMetrics:
    sql: str = ""
    # ``Context.sql_batch`` / ``sql`` / ``sql_df``: host ms from the call to
    # the plan (the cache lookup on a hit; parse + plan on a miss).
    plan_ms: float = 0.0
    # ``sql`` / ``sql_df``: host ms from the plan's start to the result on
    # the host; the result's copy waits for the card, so the device's work
    # is included. ``sql_batch``: host ms to the plan's return, the result
    # still on the card: the dispatch, and the device's work only up to
    # the plan's last internal host read.
    execute_ms: float = 0.0
    # ``sql`` / ``sql_df``: rows of the returned result. ``sql_batch``
    # leaves -1 (reading the count would wait for the card).
    rows_out: int = -1
    cached_plan: bool = False
    distributed: bool = False
    # Inner plans (derived tables, subqueries) the query ran, nested ones
    # included: each runs on every execution, a cached plan's too.
    inner_plans_run: int = 0
    # Rows of the order words the query sorted
    # (``kernels.radix_sort.sort_pairs``: joins, group-bys, ORDER BY and the
    # other sorted operators), and those rows times the bits each sort
    # covered.
    sort_rows: int = 0
    sort_row_bits: int = 0
    # Rows of the query's joins' count phases (both sides' capacities), and
    # those that ran in the hand-written kernels (``kernels.join_runs``).
    join_rows: int = 0
    join_fused_rows: int = 0
    # Rows into the query's window computations (each batch's rows, padding
    # included) and into its set operations (each arm's live rows).
    window_rows: int = 0
    setop_rows: int = 0
    # ``torch.cuda.memory_allocated`` as the query returns, less the bytes
    # of the Context's resident tables: what the query left on the card
    # (for ``sql_batch``, the returned result). An allocator statistic read
    # on the host, no sync. -1 for a Context off the card.
    held_bytes: int = -1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def log(self, level: int = logging.INFO) -> None:
        if logger.isEnabledFor(level):
            logger.log(level, "query %s", self.to_json())


class StageTimer:
    """Context-manager stopwatch: ``with StageTimer() as t: ...; t.ms``.
    ``StageTimer(name)`` also records the interval as the span ``name``."""

    def __init__(self, name: Optional[str] = None):
        self._span = _NO_SPAN if name is None else span(name)

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        self._span.__exit__(*exc)
        return False
