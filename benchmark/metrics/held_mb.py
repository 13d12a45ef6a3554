"""api layer: the mean over queries of ``Context.last_metrics.held_bytes``
in MiB: card memory allocated as a query returns beyond the Context's
resident tables, so what queries leave behind (a result kept for a cached
plan would show here). None for a program whose metrics lack the counter,
or off the card (-1)."""


def read(trace):
    held = [m.held_bytes for m in trace.query_metrics
            if getattr(m, "held_bytes", -1) >= 0]
    return sum(held) / len(held) / 2**20 if held else None
