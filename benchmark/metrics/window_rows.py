"""ops layer, a control: the mean over queries of
``Context.last_metrics.window_rows``, the rows into the query's window
computations (each batch's rows, padding included). None for a program
whose metrics lack the counter."""


def read(trace):
    rows = [m.window_rows for m in trace.query_metrics
            if getattr(m, "window_rows", None) is not None]
    return sum(rows) / len(rows) if rows else None
