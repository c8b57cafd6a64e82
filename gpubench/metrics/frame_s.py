"""frame_s: seconds per frame, the whole window over the frames completed in it."""


def read(ctx):
    return ctx.window_s / ctx.units if ctx.unit == "frame" else None
