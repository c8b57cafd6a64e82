"""kd-tree traversal: backend dispatch and the plain per-ray walk.

Counterpart of ``dod_raytracer_tpu.ops.traverse`` (the reference's
``KDTree::intersect``, ``kdtree.cpp:263-361``).  Every query goes
through ``ops.packet.packet_traverse``: the hand-written CUDA kernel for
CUDA tensors, this module's plain walk (the counterpart of the JAX
package's XLA gather walk, ``traverse.py:198-291``) for CPU tensors.

The plain walk steps the whole batch in lockstep, each ray with its own
node cursor, [tmin, tmax] interval and worklist stack: a descend phase
moves every active ray to its next leaf, then a leaf phase tests one
block of that leaf (``block_tris``, Möller–Trumbore) per ray.  Semantics
kept from the reference:

* break when the tightened clip falls below the node tmin (kdtree.cpp:286-289);
* near/far ordering including the origin-on-plane tie rule (kdtree.cpp:297-299);
* far-child skip rules ``tPlane > tmax || tPlane <= 0`` / ``tPlane < tmin``
  (kdtree.cpp:312-319);
* strict-improvement leaf hits, so duplicated straddler lanes resolve to
  the first-tested copy; any-hit stops a ray at its first hit
  (kdtree.cpp:338-341).

The traversal runs without autograd and returns the winning triangle id.
The caller recomputes the hit from it.
"""

from __future__ import annotations

import torch

from ..accel._kdtree_np import LEAF_FLAG
from .aabb import slab_test
from .ray import INF
from .triangle import mt_t_edges

# rays per lockstep walk: bounds the (rays, S, 9) leaf-block gather
_PLAIN_CHUNK = 32768


def _stack_depth(kd, cfg) -> int:
    """Worklist depth: one push max per tree level, so the build's depth
    budget (+1 margin) bounds occupancy; cfg.stack_depth (=64, the
    reference's worklist size, kdtree.cpp:279) is the upper clamp."""
    if kd.max_depth:
        return min(cfg.stack_depth, kd.max_depth + 1)
    return cfg.stack_depth


def _pack_nodes(kd) -> torch.Tensor:
    """(M, 5) f32 node table [flag|split|right|leaf_start|leaf_lanes] with
    the int fields bit-cast: one 20-byte row per node, the CUDA kernel's
    node input."""
    bc = lambda a: a.contiguous().view(torch.float32)
    return torch.stack([
        bc(kd.node_flag), kd.node_split, bc(kd.node_right),
        bc(kd.node_leaf_start), bc(kd.node_leaf_lanes)], dim=1).contiguous()


def _walk(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """Lockstep walk of one ray batch -> (t_best, prim, found)."""
    n = o.shape[0]
    dev = o.device
    chunk_lanes = kd.block_lanes
    num_blocks = kd.block_tris.shape[0]
    flag_t = kd.node_flag
    split_t = kd.node_split
    right_t = kd.node_right.long()
    start_t = kd.node_leaf_start
    lanes_t = kd.node_leaf_lanes

    inv_d = 1.0 / d
    root_hit, tmin, tmax = slab_test(kd.bounds_min, kd.bounds_max, o, inv_d, t_max)
    # kdtree.cpp:274 — also reject when tmin > clippingDistance
    active = root_hit & ~(tmin > t_max)

    zi = torch.zeros((n,), dtype=torch.long, device=dev)
    node = zi.clone()
    sp = zi.clone()
    cursor = torch.zeros((n,), dtype=torch.int32, device=dev)
    stack_node = torch.zeros((n, stack_depth), dtype=torch.long, device=dev)
    stack_tmin = torch.zeros((n, stack_depth), dtype=torch.float32, device=dev)
    stack_tmax = torch.zeros((n, stack_depth), dtype=torch.float32, device=dev)
    t_best = t_max.to(torch.float32).clone()
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)

    while bool(active.any()):
        # ---------- descend every active ray to its next leaf ----------
        while True:
            flag = flag_t[node]
            interior = active & (flag != LEAF_FLAG)
            if not bool(interior.any()):
                break
            clip = torch.minimum(t_best, t_max)
            act = active & ~(clip < tmin)  # break check (kdtree.cpp:286-289)
            do_int = act & (flag != LEAF_FLAG)

            axis = flag.clamp(0, 2).long()[:, None]
            o_ax = torch.gather(o, 1, axis)[:, 0]
            d_ax = torch.gather(d, 1, axis)[:, 0]
            inv_ax = torch.gather(inv_d, 1, axis)[:, 0]
            split = split_t[node]
            right = right_t[node]
            t_plane = (split - o_ax) * inv_ax
            left_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0.0))
            near = torch.where(left_first, node + 1, right)
            far = torch.where(left_first, right, node + 1)

            skip_far = (t_plane > tmax) | (t_plane <= 0.0)
            skip_near = ~skip_far & (t_plane < tmin)
            push = ~skip_far & ~skip_near
            node_i = torch.where(skip_far, near, torch.where(skip_near, far, near))
            tmax_i = torch.where(push, t_plane, tmax)

            ip = torch.nonzero(do_int & push)[:, 0]
            sp_c = sp[ip].clamp(0, stack_depth - 1)
            stack_node[ip, sp_c] = far[ip]
            stack_tmin[ip, sp_c] = t_plane[ip]
            stack_tmax[ip, sp_c] = tmax[ip]
            sp = torch.where(do_int & push, sp + 1, sp)

            active = torch.where(interior, act, active)
            node = torch.where(do_int, node_i, node)
            tmax = torch.where(do_int, tmax_i, tmax)

        # ---------- one leaf block per active ray (kdtree.cpp:331-358) ----------
        clip = torch.minimum(t_best, t_max)
        act = active & ~(clip < tmin)
        leaf_start = start_t[node]
        leaf_lanes = lanes_t[node]
        ia = torch.nonzero(act)[:, 0]
        blk = torch.clamp((leaf_start[ia] + cursor[ia]) // chunk_lanes, 0, num_blocks - 1).long()
        tri = kd.block_tris[blk]  # (k, S, 9)
        orig = kd.block_orig[blk]  # (k, S)
        t = mt_t_edges(tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], o[ia], d[ia])
        t = torch.where(orig >= 0, t, INF)
        a = torch.argmin(t, dim=1, keepdim=True)
        t_leaf = torch.gather(t, 1, a)[:, 0]
        prim_leaf = torch.gather(orig, 1, a)[:, 0]
        better = t_leaf < clip[ia]
        ib = ia[better]
        t_best[ib] = t_leaf[better]
        prim_best[ib] = prim_leaf[better]
        improved = torch.zeros_like(act)
        improved[ib] = True
        found = found | improved

        cursor = torch.where(act, cursor + chunk_lanes, cursor)
        leaf_done = act & (cursor >= leaf_lanes)
        if any_hit:
            # returnOnAny (kdtree.cpp:338-341): stop this ray immediately
            leaf_done = leaf_done & ~improved
            act = act & ~improved

        # pop worklist or finish (kdtree.cpp:347-357)
        can_pop = sp > 0
        pop = leaf_done & can_pop
        sp_pop = (sp - 1).clamp(0, stack_depth - 1)
        act = act & ~(leaf_done & ~can_pop)
        node = torch.where(pop, stack_node[rows, sp_pop], node)
        tmin = torch.where(pop, stack_tmin[rows, sp_pop], tmin)
        tmax = torch.where(pop, stack_tmax[rows, sp_pop], tmax)
        sp = torch.where(pop, sp - 1, sp)
        cursor = torch.where(pop, 0, cursor)
        active = act

    return t_best, prim_best, found


@torch.no_grad()
def traverse_plain(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """Plain per-ray kd walk -> (t_best (N,) f32, prim (N,) i32 or -1,
    found (N,) bool), in chunks of ``_PLAIN_CHUNK`` rays (rays are
    independent, so chunking does not change any result)."""
    outs = [_walk(kd, o[s:s + _PLAIN_CHUNK], d[s:s + _PLAIN_CHUNK],
                  t_max[s:s + _PLAIN_CHUNK], stack_depth, any_hit)
            for s in range(0, o.shape[0], _PLAIN_CHUNK)]
    if not outs:
        return (t_max.to(torch.float32).clone(),
                torch.zeros((0,), dtype=torch.int32, device=o.device),
                torch.zeros((0,), dtype=torch.bool, device=o.device))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _backend(kd, cfg) -> str:
    """'auto' and 'packet' -> the packet wrapper; every other name of the
    JAX package ('xla', 'binned', 'mega', 'forest') is not ported.  The
    JAX package's 900 KB TPU SMEM gate has no counterpart: the CUDA
    kernel reads its tables from global memory through L2."""
    be = getattr(cfg, "traversal_backend", "auto")
    if be in ("auto", "packet"):
        return "packet"
    raise NotImplementedError(f"traversal_backend={be!r} is not ported")


def _traverse(kd, o, d, t_max, cfg, any_hit: bool):
    from .packet import packet_traverse

    _backend(kd, cfg)
    o, d = o.contiguous(), d.contiguous()
    t_max = t_max.to(torch.float32).contiguous()
    return packet_traverse(kd, o, d, t_max, _stack_depth(kd, cfg), any_hit)


@torch.no_grad()
def kd_closest(kd, triangles, o, d, t_max, cfg):
    """Closest-hit traversal -> (t_best (N,), orig tri idx (N,), hit (N,)).

    ``triangles`` is unused (the walks read the kd blocks); it is kept so
    the signature matches the JAX package's.
    """
    t_best, prim, found = _traverse(kd, o.detach(), d.detach(), t_max.detach(), cfg, False)
    return t_best, torch.clamp_min(prim, 0), found & (t_best < t_max)


@torch.no_grad()
def kd_any(kd, triangles, o, d, t_max, cfg):
    """Any-hit traversal (shadow rays): True where occluded before t_max."""
    _, _, found = _traverse(kd, o.detach(), d.detach(), t_max.detach(), cfg, True)
    return found
