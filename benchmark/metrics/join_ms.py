"""ops layer: device ms per query enqueued inside the port's ``hark.join``
spans, both children (``hark.join.count``: the concat sort and ranges;
``hark.join.fill``: gathers, compactions, kernel D) and the total's read."""

from harness.spans import operator_ms_per_query


def read(trace):
    return operator_ms_per_query(trace, "hark.join")
