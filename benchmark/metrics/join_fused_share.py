"""ops layer: the share of the joins' count-phase rows that ran in the
port's two hand-written count-phase kernels (``kernels/join_runs``):
100 x Σ ``Context.last_metrics.join_fused_rows`` / Σ ``join_rows`` over the
window's queries, in %. None for a program whose metrics lack the
counters, or a window that joined nothing."""


def read(trace):
    counted = [m for m in trace.query_metrics
               if getattr(m, "join_rows", None) is not None]
    rows = sum(m.join_rows for m in counted)
    if not rows:
        return None
    return 100.0 * sum(m.join_fused_rows for m in counted) / rows
