"""ops layer: device ms per query enqueued inside the port's ``hark.filter``
spans (predicate evaluation and compaction, kernel A: the pushed-down WHERE
of each table, the residual WHERE's mask, a deferred mask applied alone)."""

from harness.spans import operator_ms_per_query


def read(trace):
    return operator_ms_per_query(trace, "hark.filter")
