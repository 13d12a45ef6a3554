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
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("harkdb_tpu_torch")

_NO_SPAN = contextlib.nullcontext()


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
