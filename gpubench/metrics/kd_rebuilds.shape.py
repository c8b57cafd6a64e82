"""kd_rebuilds.shape: the program's kd rebuilds (counter ``kd.rebuilds``: a
triangle left the box its lane was filed by, and the lanes were filed
again) per 100 steps of the window.
None where the program counts no gradient rows (``grad.geom.rows``): it
then has no tracer counters for this fit at all."""


def read(ctx):
    c = ctx.host.get("counters") or {}
    steps = ctx.host.get("steps")
    if "grad.geom.rows" not in c or not steps:
        return None
    return 100.0 * c.get("kd.rebuilds", 0) / steps
