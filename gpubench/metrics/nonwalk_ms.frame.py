"""nonwalk_ms.frame: device milliseconds per frame of every kernel that is not
a kd-walk kernel (the families, shading, sorts and glue: torch's kernels)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.unit != "frame":
        return None
    mask = tr.kernels() & ~ctx.module("kd_walk_ms.frame").walk_mask(tr)
    return 1e3 * sum(tr.seconds_by_name(mask).values()) / ctx.units
