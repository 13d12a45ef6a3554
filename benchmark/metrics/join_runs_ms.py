"""ops layer: device ms per query enqueued inside the port's
``hark.join.count`` spans (and their children) less what their
``hark.join.count.sort`` spans enqueued: the join's count phase around its
pair sort (order words, tags, run arithmetic, per-side splits, totals).
None for a program that opens no ``hark.join.count.sort`` span."""

from harness.spans import operator_ms_per_query

COUNT = "hark.join.count"
SORT = "hark.join.count.sort"


def read(trace):
    if not any(s.name == SORT for s in trace.host_ops):
        return None
    return (operator_ms_per_query(trace, COUNT)
            - operator_ms_per_query(trace, SORT))
