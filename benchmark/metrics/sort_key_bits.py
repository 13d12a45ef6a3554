"""ops layer: the bits a sorted row's order word covers, weighted by rows:
Σ ``Context.last_metrics.sort_row_bits`` / Σ ``sort_rows`` over the
window's queries (the port's ``ops.sort.sort_pairs`` counts both: the
joins', group-bys' and ORDER BYs' sorts). None for a program whose metrics
lack the counters, or a window that sorted nothing."""


def read(trace):
    counted = [m for m in trace.query_metrics
               if getattr(m, "sort_rows", None) is not None]
    rows = sum(m.sort_rows for m in counted)
    return sum(m.sort_row_bits for m in counted) / rows if rows else None
