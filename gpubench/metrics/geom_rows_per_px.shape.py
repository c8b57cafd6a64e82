"""geom_rows_per_px.shape: the program's counter ``grad.geom.rows`` (the
triangle-hit rows computed with gradient to the vertex positions, summed
over a step's bounces, counted on the host from shapes) per pixel per step
of the window.  None where the program has no such counter."""


def read(ctx):
    c = ctx.host.get("counters") or {}
    steps, pixels = ctx.host.get("steps"), ctx.host.get("pixels")
    if "grad.geom.rows" not in c or not steps or not pixels:
        return None
    return c["grad.geom.rows"] / (pixels * steps)
