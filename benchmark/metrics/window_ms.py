"""ops layer: device ms per query enqueued inside the port's
``hark.window`` spans: each window computation's sorts, scans and
broadcasts (``plan/windows.py``), windows over grouped results included.
None for a program that opens no ``hark.window`` span."""

from harness.spans import operator_ms_per_query

SPAN = "hark.window"


def read(trace):
    if not any(s.name == SPAN for s in trace.host_ops):
        return None
    return operator_ms_per_query(trace, SPAN)
