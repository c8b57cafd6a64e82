"""device_idle_pct.fit: as device_idle_pct.frame, over the fit's window."""


def read(ctx):
    if ctx.trace is None or ctx.unit != "step":
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.window_s)
