"""step_s: seconds per Adam step, the whole window over the steps completed in it."""


def read(ctx):
    return ctx.window_s / ctx.units if ctx.unit == "step" else None
