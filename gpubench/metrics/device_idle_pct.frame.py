"""device_idle_pct.frame: share (%) of the window in which no device
operation ran: the union of the trace's device intervals over the window,
not a sum of kernel times over a wall clock."""


def read(ctx):
    if ctx.trace is None or ctx.unit != "frame":
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.window_s)
