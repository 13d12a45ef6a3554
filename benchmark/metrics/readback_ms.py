"""api layer: device ms per query in device-to-host copies (the result's
return through ``ColumnBatch.to_numpy`` and the host reads on the way)."""


def read(trace):
    return trace.device_ms_per_query(lambda n: n.startswith("Memcpy DtoH"))
