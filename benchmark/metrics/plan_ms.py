"""sql + plan layer: mean ``Context.last_metrics.plan_ms`` per query
(parse, plan and the planner's subqueries on a plan-cache miss; the cache
lookup on a hit)."""


def read(trace):
    ms = [m.plan_ms for m in trace.query_metrics]
    return sum(ms) / len(ms) if ms else None
