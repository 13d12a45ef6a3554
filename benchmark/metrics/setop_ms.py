"""ops layer: device ms per query enqueued inside the port's
``hark.setop`` spans: the combination of a set operation's arms (code
remaps into the merged dictionaries, the concatenation, the sort or
dedupe and the membership test, the trailing ORDER BY), not the arms'
own plans. None for a program that opens no ``hark.setop`` span."""

from harness.spans import operator_ms_per_query

SPAN = "hark.setop"


def read(trace):
    if not any(s.name == SPAN for s in trace.host_ops):
        return None
    return operator_ms_per_query(trace, SPAN)
