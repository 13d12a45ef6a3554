"""plan execute layer: times per query the host waited for the card
(stream, device and event synchronisations and blocking copies in the
trace)."""

from harness.trace import SYNC_CALLS


def read(trace):
    if not trace.n_queries:
        return None
    return trace.runtime_count(SYNC_CALLS) / trace.n_queries
