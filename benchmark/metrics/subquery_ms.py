"""sql + plan layer: device ms per query enqueued inside the port's
``hark.subquery`` spans, the operators nested in them included: the inner
plans of derived tables, CTEs, views, decorrelated and plain subqueries,
which run on every execution. Overlaps ``join_ms``, ``groupby_ms`` and
``filter_ms``, which read the same ops by their innermost operator. None
for a trace in which no inner plan ran."""

from harness.spans import innermost

SPAN = "hark.subquery"


def read(trace):
    subs = [s for s in trace.host_ops if s.name == SPAN]
    if not trace.n_queries or not subs:
        return None
    calls = {s.corr: s for s in trace.runtime if s.corr}
    made = sorted({d.corr for d in trace.device if d.corr in calls})
    inside = dict(zip(made, innermost(subs, [calls[c].start for c in made])))
    ns = sum(d.end - d.start for d in trace.device
             if inside.get(d.corr) is not None)
    return ns / 1e6 / trace.n_queries
