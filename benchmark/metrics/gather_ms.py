"""ops layer: device ms per query in index and gather kernels (the
gathers of join and sort permutations)."""

NAMES = ("index_elementwise", "gather", "index_select", "indexselect")


def read(trace):
    return trace.device_ms_per_query(
        lambda n: any(k in n.lower() for k in NAMES))
