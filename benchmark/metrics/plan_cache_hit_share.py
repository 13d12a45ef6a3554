"""sql + plan layer: % of queries whose plan came from the Context's plan
cache (``Context.last_metrics.cached_plan``)."""


def read(trace):
    hits = [bool(m.cached_plan) for m in trace.query_metrics]
    return 100.0 * sum(hits) / len(hits) if hits else None
