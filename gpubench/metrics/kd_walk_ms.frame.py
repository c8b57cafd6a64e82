"""kd_walk_ms.frame: device milliseconds per frame of the kd-walk kernels.

A kernel belongs to the kd walk when its name holds one of ``PATTERNS``:
the port's hand-written traversal and leaf-test kernels (the packet, mega
and forest warp walks, the per-ray walks, the binned walk's round kernel
and block loop, the brute-force kernels and their merge)."""

PATTERNS = ("warp_walk_kernel", "kd_walk_kernel", "packet_traverse_ray_kernel", "block_loop",
            "descend_kernel", "binned_descend", "closest_kernel", "unpack_kernel", "mt_closest",
            "plucker_closest", "PacketNodes", "MegaNodes", "ForestNodes")


def is_walk(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def walk_mask(tr):
    return tr.kernels() & tr.name_mask(is_walk)


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.unit != "frame":
        return None
    s = sum(tr.seconds_by_name(walk_mask(tr)).values())
    return 1e3 * s / ctx.units if s > 0 else None
