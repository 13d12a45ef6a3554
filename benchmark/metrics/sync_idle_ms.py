"""plan execute layer: device idle ms per query in the window's gaps that
open while the host is inside one of the port's ``hark.sync.*`` spans: the
card drained, waiting for a host read and what the host enqueues after
it."""

from harness.spans import sync_idle_ms_per_query


def read(trace):
    return sync_idle_ms_per_query(trace)
