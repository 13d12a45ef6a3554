"""The traced window's device time and idle gaps put down to the port's own
spans (``harkdb_tpu_torch/utils/metrics.py``): ``hark.<operator>`` ranges
around the planner's operators and ``hark.sync.<site>`` ranges around its
blocking host reads, all ``record_function`` ranges on the profiler's
clock, in ``Trace.host_ops``.

A device op belongs to the runtime call with its correlation id (the
launch, copy or set that enqueued it), and that call to the innermost
operator span open on the host when it was made: ``hark.sync.*`` ranges are
not operators, so a read's copy stays with the operator that read it.
Every reader returns None when the trace holds no ``hark.`` range (a
program without the spans), never a false 0.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from harness.trace import Span, Trace

PREFIX = "hark."
SYNC = "hark.sync."


def has_spans(trace: Trace) -> bool:
    return any(s.name.startswith(PREFIX) for s in trace.host_ops)


def innermost(spans: Sequence[Span], points: Sequence[int]
              ) -> List[Optional[Span]]:
    """For each point (ns), the innermost of ``spans`` open at it, or None.
    The spans nest properly, as one thread's ranges do."""
    order = sorted(range(len(points)), key=points.__getitem__)
    by_start = sorted(spans, key=lambda s: (s.start, -s.end))
    out: List[Optional[Span]] = [None] * len(points)
    stack: List[Span] = []
    i = 0
    for k in order:
        t = points[k]
        while i < len(by_start) and by_start[i].start <= t:
            while stack and stack[-1].end < by_start[i].start:
                stack.pop()
            stack.append(by_start[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def owners(trace: Trace) -> List[Optional[Span]]:
    """For each of ``trace.device``, the operator span it was enqueued in:
    None outside every operator span, or with no runtime call found."""
    ops = [s for s in trace.host_ops
           if s.name.startswith(PREFIX) and not s.name.startswith(SYNC)]
    calls = {s.corr: s for s in trace.runtime if s.corr}
    made = sorted({d.corr for d in trace.device if d.corr in calls})
    where = dict(zip(made, innermost(ops, [calls[c].start for c in made])))
    return [where.get(d.corr) for d in trace.device]


def operator_ns(trace: Trace) -> Dict[Optional[str], int]:
    """Device ns by the name of the operator span it was enqueued in."""
    out: Dict[Optional[str], int] = defaultdict(int)
    for d, span in zip(trace.device, owners(trace)):
        out[span.name if span is not None else None] += d.end - d.start
    return out


def operator_ms_per_query(trace: Trace, name: str) -> Optional[float]:
    """Device ms per query enqueued inside the operator span ``name`` or
    its children (``name.*``)."""
    if not trace.n_queries or not has_spans(trace):
        return None
    ns = sum(v for k, v in operator_ns(trace).items()
             if k is not None and (k == name or k.startswith(name + ".")))
    return ns / 1e6 / trace.n_queries


def sync_idle_ms_per_query(trace: Trace) -> Optional[float]:
    """Device idle ms per query in the window's gaps that open while the
    host is inside a ``hark.sync.*`` span: the card drained, waiting for
    the host to read its result and enqueue more."""
    if not trace.n_queries or not has_spans(trace):
        return None
    b = trace.busy_intervals()
    lo, hi = trace.window
    starts = [lo] + b[:, 1].tolist()
    ends = b[:, 0].tolist() + [hi]
    gaps = [(a, e) for a, e in zip(starts, ends) if e > a]
    syncs = [s for s in trace.host_ops if s.name.startswith(SYNC)]
    open_at = innermost(syncs, [a for a, _e in gaps])
    ns = sum(e - a for (a, e), s in zip(gaps, open_at) if s is not None)
    return ns / 1e6 / trace.n_queries
