"""device layer: % of the window in which nothing ran on the card (one
minus the union of kernel, copy and set intervals over the window)."""


def read(trace):
    w = trace.window_s()
    if w <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / w)
