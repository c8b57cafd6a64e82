"""launches_per_frame.frame: device kernels on the trace's timeline in the
window, over the frames completed in it (copies and fills not counted)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.unit != "frame":
        return None
    return int(tr.kernels().sum()) / ctx.units
