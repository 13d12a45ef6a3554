"""ops layer: device ms per query enqueued inside the port's
``hark.join.fill.gather`` spans: the join's late materialization, one
gather (and its mask) per carried column at the output's size, inside
``hark.join.fill`` and so inside ``join_ms``. None for a program that
opens no such span."""

from harness.spans import operator_ms_per_query

SPAN = "hark.join.fill.gather"


def read(trace):
    if not any(s.name == SPAN for s in trace.host_ops):
        return None
    return operator_ms_per_query(trace, SPAN)
