"""plan execute layer: kernel launches the host made per query (the CUDA
runtime's launch calls in the trace)."""

from harness.trace import LAUNCH_CALLS


def read(trace):
    if not trace.n_queries:
        return None
    return trace.runtime_count(LAUNCH_CALLS) / trace.n_queries
