"""kd_walk_roofline: the least time the kd queries of a frame need, as a share
(%) of ``kd_walk_ms.frame``.

The count is the queries the frame's semantics make, not the work of an
implementation: one closest-hit query for each ray still active at a
bounce, and one shadow query for each light that faces an active hit
(``shade > 0``).  The plain reference counts both over its sample of the
frame's pixels (``traffic/frames.py``), and the frame's count is that
mean a pixel times the pixels.  A closest-hit query reads o, d and t_max
(28 bytes) and writes t and the triangle (8 bytes); a shadow query reads
28 bytes and writes 1.  The bound is those bytes over the card's memory
bandwidth (``peaks.json``): it ignores the tree, so no builder, pruning or
kernel can make the count stale or lift the share past 100%."""

CLOSEST_BYTES = 28 + 8
SHADOW_BYTES = 28 + 1


def least_s(work: dict, bytes_per_s: float) -> float:
    per_px = work["closest_per_px"] * CLOSEST_BYTES + work["shadow_per_px"] * SHADOW_BYTES
    return work["pixels"] * per_px / bytes_per_s


def read(ctx):
    walk_ms = ctx.read("kd_walk_ms.frame")
    peak = ctx.peak("hbm_bytes_per_s")
    if walk_ms is None or peak is None or "shadow_per_px" not in ctx.work:
        return None
    return 100.0 * least_s(ctx.work, peak) / (walk_ms / 1e3)
