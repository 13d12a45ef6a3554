"""ops layer: device ms per query in radix-sort kernels (the sorts of
joins, GROUP BY and ORDER BY)."""


def read(trace):
    return trace.device_ms_per_query(
        lambda n: "RadixSort" in n or "radixSort" in n)
