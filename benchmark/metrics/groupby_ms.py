"""ops layer: device ms per query enqueued inside the port's
``hark.groupby`` spans (the dense path's kernel C or the sort path, the
dense probe, AVG's divisions, HAVING and the group count's read)."""

from harness.spans import operator_ms_per_query


def read(trace):
    return operator_ms_per_query(trace, "hark.groupby")
