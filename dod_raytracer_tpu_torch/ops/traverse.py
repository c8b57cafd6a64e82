"""kd-tree traversal: backend dispatch and the plain per-ray walks.

Counterpart of ``dod_raytracer_tpu.ops.traverse`` (the reference's
``KDTree::intersect``, ``kdtree.cpp:263-361``).  ``_backend`` resolves
``cfg.traversal_backend`` as the JAX package does.  Each kernel backend is
the wrapper of a hand-written CUDA kernel (``ops.packet``, ``ops.mega``,
``ops.forest``, ``ops.binned``) that takes this module's plain walk for
CPU tensors; ``"xla"`` is ``traverse_xla``, pure torch on either device.

The plain walk (``_walk``) steps the whole batch in lockstep, each ray
with its own node cursor, [tmin, tmax] interval and worklist stack: a
descend phase moves every active ray to its next leaf, then a leaf phase
hands each ray that has lanes left in its leaf to a leaf stage with the
key of one block, ``(leaf_start + cursor) // block_lanes``.  The leaf
stage is an argument:

* ``leaf_plain``, the CUDA kernels' leaf test (``csrc/kd_leaf.cuh``): the
  Plücker edge signs on rows 0-5 of ``block_g``, then the Möller–Trumbore
  t on ``block_tris`` for the slots inside all three edges, each operation
  in the kernels' order, so a kernel and its plain version give the same
  bits (``traverse_plain``, ``traverse_forest_plain``);
* the CUDA block-loop kernel running that same test (the binned walk,
  ``ops.binned.binned_traverse``, the JAX package's ``_traverse_binned``);
* ``leaf_barycentric``, Möller–Trumbore with its barycentric tests, the
  JAX package's XLA gather walk (``traverse_xla``, ``traverse.py:198-291``).

Semantics kept from the reference:

* break when the tightened clip falls below the node tmin (kdtree.cpp:286-289);
* near/far ordering including the origin-on-plane tie rule (kdtree.cpp:297-299);
* far-child skip rules ``tPlane > tmax || tPlane <= 0`` / ``tPlane < tmin``
  (kdtree.cpp:312-319);
* strict-improvement leaf hits, so duplicated straddler lanes resolve to
  the first-tested copy; any-hit stops a ray at its first hit
  (kdtree.cpp:338-341).

``traverse_forest_plain`` is the same walk over the treelet forest
(``top_tbl`` / ``tre_tbl``), the forest kernel's plain version: a ray
descends the top table to a super-leaf, walks that treelet with local
node ids, and returns to the top table at the pop that brings its stack
back to the depth ``sp_enter`` it had on entry.  Its visit order, and so
every output bit, is the one-table walk's.

The traversal runs without autograd and returns the winning triangle id.
The caller recomputes the hit from it.
"""

from __future__ import annotations

import torch

from ..accel._kdtree_np import LEAF_FLAG, MAX_NODES, TOP_LEAF_FLAG
from ..utils import profiling
from .aabb import slab_test
from .ray import INF
from .triangle import mt_t_edges, plucker_inside, plucker_row

# rays per lockstep walk: bounds the (rays, S, 9) leaf-block gather
_PLAIN_CHUNK = 32768
# prim of a ray whose block holds no hit (block_loop_kernel.py _BIG_I)
NO_HIT = 2**30


def _stack_depth(kd, cfg) -> int:
    """Worklist depth: one push max per tree level, so the build's depth
    budget (+1 margin) bounds occupancy; cfg.stack_depth (=64, the
    reference's worklist size, kdtree.cpp:279) is the upper clamp."""
    if kd.max_depth:
        return min(cfg.stack_depth, kd.max_depth + 1)
    return cfg.stack_depth


def _pack_nodes(kd) -> torch.Tensor:
    """(M, 5) f32 node table [flag|split|right|leaf_start|leaf_lanes] with
    the int fields bit-cast: one 20-byte row per node, the packet kernel's
    node input."""
    bc = lambda a: a.contiguous().view(torch.float32)
    return torch.stack([
        bc(kd.node_flag), kd.node_split, bc(kd.node_right),
        bc(kd.node_leaf_start), bc(kd.node_leaf_lanes)], dim=1).contiguous()


def _row_fetch(kd, forest: bool):
    """The walk's node-row fetch: (node, in_tre, cur_tre) -> (flag, split,
    right, block0, leaf_lanes, treelet).  One table: the kd node arrays.
    Forest: the top table where ``in_tre`` is False, else the row of the
    ray's treelet; ``treelet`` is a top row's super-leaf target."""
    if not forest:
        right = kd.node_right.long()
        block0 = (kd.node_leaf_start // max(kd.block_lanes, 1)).long()

        def fetch(node, in_tre, cur_tre):
            return (kd.node_flag[node], kd.node_split[node], right[node], block0[node],
                    kd.node_leaf_lanes[node], None)

        return fetch
    top, tre = kd.top_tbl, kd.tre_tbl
    last_top, last_row = top.shape[0] - 1, tre.shape[1] - 1

    def fetch(node, in_tre, cur_tre):
        tf = top[node.clamp(max=last_top)]
        ti = tf.view(torch.int32)
        rf = tre[cur_tre, node.clamp(max=last_row)]
        ri = rf.view(torch.int32)
        return (torch.where(in_tre, ri[:, 0], ti[:, 0]), torch.where(in_tre, rf[:, 1], tf[:, 1]),
                torch.where(in_tre, ri[:, 2], ti[:, 2]).long(), ri[:, 5].long(), ri[:, 4],
                ti[:, 3].long())

    return fetch


def _first_hit(t, orig):
    """(k, S) candidate t and ids -> (t, prim) of the first strict minimum
    in slot order; prim is NO_HIT where no slot hits."""
    a = torch.argmin(t, dim=1, keepdim=True)
    t_leaf = torch.gather(t, 1, a)[:, 0]
    prim = torch.gather(orig, 1, a)[:, 0]
    return t_leaf, torch.where(t_leaf < INF, prim, NO_HIT)


def leaf_plain(kd, o, d, keys):
    """The kernels' leaf test of one block per ray -> (t (k,) f32, prim (k,)
    i32): the Plücker edge signs on rows 0-5 of ``block_g``, then the
    Möller–Trumbore t on ``block_tris``, each operation in the kernels'
    order (``csrc/kd_leaf.cuh``).  (inf, NO_HIT) where no slot of block
    ``keys[i]`` is hit or the key is outside [0, B), as the JAX package's
    ``block_loop_intersect``.  The plain version of
    ``ops.binned.block_loop_intersect`` and the leaf stage of every plain
    walk."""
    num_blocks, slots = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    blk = keys.long().clamp(0, num_blocks - 1)
    tri = kd.block_tris[blk]  # (k, S, 9)
    orig = kd.block_orig[blk]  # (k, S)
    g = kd.block_g[blk, :6, :3 * spad].reshape(-1, 6, 3, spad)[..., :slots]
    inside = plucker_inside(plucker_row(o, d), g)
    t = mt_t_edges(tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], o, d, inside)
    live = (orig >= 0) & ((keys >= 0) & (keys < num_blocks))[:, None]
    return _first_hit(torch.where(live, t, INF), orig)


def leaf_barycentric(kd, o, d, keys):
    """The JAX package's gather-walk leaf stage (``_gather_leaf_t``, its
    blocked branch): Möller–Trumbore with its barycentric u/v tests on
    ``block_tris``, no edge signs -> (t, prim) as ``leaf_plain``."""
    blk = keys.long()
    tri = kd.block_tris[blk]
    orig = kd.block_orig[blk]
    t = mt_t_edges(tri[..., 0:3], tri[..., 3:6], tri[..., 6:9], o, d)
    return _first_hit(torch.where(orig >= 0, t, INF), orig)


def _walk(kd, o, d, t_max, stack_depth: int, any_hit: bool, forest: bool, leaf):
    """Lockstep walk of one ray batch -> (t_best, prim, found).

    ``leaf(kd, o, d, keys) -> (t, prim)`` is the leaf stage: for each ray
    given, the first strict-minimum hit in block ``keys[i]`` (int32), with
    t = inf where none (``leaf_plain``, ``leaf_barycentric``, or the CUDA
    kernel ``ops.binned.block_loop_intersect``)."""
    n = o.shape[0]
    dev = o.device
    chunk_lanes = kd.block_lanes
    num_blocks = kd.block_orig.shape[0]
    fetch = _row_fetch(kd, forest)

    inv_d = 1.0 / d
    root_hit, tmin, tmax = slab_test(kd.bounds_min, kd.bounds_max, o, inv_d, t_max)
    # kdtree.cpp:274 — also reject when tmin > clippingDistance
    active = root_hit & ~(tmin > t_max)

    zi = torch.zeros((n,), dtype=torch.long, device=dev)
    node = zi.clone()
    sp = zi.clone()
    cursor = torch.zeros((n,), dtype=torch.int32, device=dev)
    # forest: in a treelet (else in the top table), which one, and the
    # stack depth on entry (the watermark)
    in_tre = torch.full((n,), not forest, dtype=torch.bool, device=dev)
    cur_tre = zi.clone()
    sp_enter = zi.clone()
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
            flag, split, right, _, _, target = fetch(node, in_tre, cur_tre)
            interior = active & (flag < LEAF_FLAG)
            enter = active & ~in_tre & (flag == TOP_LEAF_FLAG)  # forest super-leaf
            if not bool((interior | enter).any()):
                break
            clip = torch.minimum(t_best, t_max)
            act = active & ~(clip < tmin)  # break check (kdtree.cpp:286-289)
            do_int = act & interior

            axis = flag.clamp(0, 2).long()[:, None]
            o_ax = torch.gather(o, 1, axis)[:, 0]
            d_ax = torch.gather(d, 1, axis)[:, 0]
            inv_ax = torch.gather(inv_d, 1, axis)[:, 0]
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

            active = torch.where(interior | enter, act, active)
            node = torch.where(do_int, node_i, node)
            tmax = torch.where(do_int, tmax_i, tmax)
            if forest:  # enter the super-leaf's treelet at its local root
                do_enter = act & enter
                in_tre = in_tre | do_enter
                cur_tre = torch.where(do_enter, target, cur_tre)
                node = torch.where(do_enter, 0, node)
                sp_enter = torch.where(do_enter, sp, sp_enter)

        # ---------- one leaf block per ray with work (kdtree.cpp:331-358) ----------
        _, _, _, block0, leaf_lanes, _ = fetch(node, in_tre, cur_tre)
        clip = torch.minimum(t_best, t_max)
        act = active & ~(clip < tmin)
        ia = torch.nonzero(act & (cursor < leaf_lanes))[:, 0]  # an empty leaf tests no block
        keys = torch.clamp(block0[ia] + cursor[ia] // chunk_lanes, 0, num_blocks - 1).to(torch.int32)
        t_leaf, prim_leaf = leaf(kd, o[ia], d[ia], keys)
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

        # pop worklist or finish (kdtree.cpp:347-357); in the forest, the
        # pop at the watermark restores a top-table id (back to top mode)
        can_pop = sp > 0
        pop = leaf_done & can_pop
        in_tre = in_tre & ~(pop & (sp == sp_enter))
        sp_pop = (sp - 1).clamp(0, stack_depth - 1)
        act = act & ~(leaf_done & ~can_pop)
        node = torch.where(pop, stack_node[rows, sp_pop], node)
        tmin = torch.where(pop, stack_tmin[rows, sp_pop], tmin)
        tmax = torch.where(pop, stack_tmax[rows, sp_pop], tmax)
        sp = torch.where(pop, sp - 1, sp)
        cursor = torch.where(pop, 0, cursor)
        active = act

    return t_best, prim_best, found


def _chunked(kd, o, d, t_max, stack_depth: int, any_hit: bool, forest: bool, leaf):
    """The walk in chunks of ``_PLAIN_CHUNK`` rays (rays are independent,
    so chunking does not change any result)."""
    outs = [_walk(kd, o[s:s + _PLAIN_CHUNK], d[s:s + _PLAIN_CHUNK],
                  t_max[s:s + _PLAIN_CHUNK], stack_depth, any_hit, forest, leaf)
            for s in range(0, o.shape[0], _PLAIN_CHUNK)]
    if not outs:
        return (t_max.to(torch.float32).clone(),
                torch.zeros((0,), dtype=torch.int32, device=o.device),
                torch.zeros((0,), dtype=torch.bool, device=o.device))
    return tuple(torch.cat(parts) for parts in zip(*outs))


@torch.no_grad()
def traverse_plain(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """Plain per-ray kd walk -> (t_best (N,) f32, prim (N,) i32 or -1,
    found (N,) bool): the packet, mega and binned kernels' plain version."""
    return _chunked(kd, o, d, t_max, stack_depth, any_hit, False, leaf_plain)


@torch.no_grad()
def traverse_forest_plain(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """The plain walk over the treelet forest (``kd.top_tbl`` /
    ``kd.tre_tbl``), the forest kernel's plain version: the same outputs
    as ``traverse_plain``."""
    if kd.tre_tbl is None or kd.top_tbl is None:
        raise ValueError("the forest walk needs kd.tre_tbl and kd.top_tbl")
    return _chunked(kd, o, d, t_max, stack_depth, any_hit, True, leaf_plain)


@torch.no_grad()
def traverse_xla(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """The JAX package's XLA gather walk (``_traverse``, its off-TPU
    ``"auto"``): the plain walk with the barycentric leaf stage
    (``leaf_barycentric``).  Pure torch: the JAX package runs it outside
    any Pallas kernel."""
    return _chunked(kd, o, d, t_max, stack_depth, any_hit, False, leaf_barycentric)


def _backend(kd, cfg) -> str:
    """``cfg.traversal_backend`` -> 'packet', 'mega', 'forest', 'binned' or
    'xla', resolved as the JAX package's ``_backend``
    (``traverse.py:486-529``) resolves them on its accelerator:

    * 'auto' and 'packet' -> packet.  The JAX package's 900 KB TPU SMEM
      gate has no counterpart: the CUDA kernel reads its tables from
      global memory through L2;
    * 'forest' on a tree with treelet tables -> forest;
    * 'mega' on a tree of at most MAX_NODES nodes, and 'forest' there
      without tables -> mega;
    * 'mega' on a bigger tree, and 'forest' there without tables -> binned;
    * 'binned' and 'xla' -> themselves.

    A tree without ``block_g`` or ``block_aabb`` (every build of the port
    fills both) keeps its kernel backend, whose wrapper raises for CUDA
    tensors; the JAX package gives way to a slower walk there.  A name
    the JAX package does not know raises ``ValueError`` (JAX takes its XLA
    walk for it).
    """
    return resolve_backend(cfg, kd.tre_tbl is not None and kd.top_tbl is not None, kd.node_flag.shape[0])


def resolve_backend(cfg, treelets: bool, n_nodes: int) -> str:
    """``_backend`` for a tree with (``treelets``) or without treelet
    tables and ``n_nodes`` nodes."""
    be = getattr(cfg, "traversal_backend", "auto")
    if be not in ("auto", "packet", "mega", "forest", "binned", "xla"):
        raise ValueError(f"unknown traversal_backend {be!r}")
    if be in ("auto", "packet"):
        return "packet"
    if be in ("mega", "forest"):
        if be == "forest" and treelets:
            return "forest"
        return "binned" if n_nodes > MAX_NODES else "mega"
    return be


def _traverse(kd, o, d, t_max, cfg, any_hit: bool):
    """The one door to every backend's walk: the span ``kd.closest`` or
    ``kd.any`` and the counter ``kd.lanes.<mode>`` of the lanes handed to
    the walk, dead lanes (t_max < 0) included."""
    be = _backend(kd, cfg)
    if be == "packet":
        from .packet import packet_traverse as walk
    elif be == "mega":
        from .mega import mega_traverse as walk
    elif be == "forest":
        from .forest import forest_traverse as walk
    elif be == "binned":
        from .binned import binned_traverse as walk
    else:
        walk = traverse_xla
    name, lanes = ("kd.any", "kd.lanes.any") if any_hit else ("kd.closest", "kd.lanes.closest")
    profiling.count(lanes, o.shape[0])
    with profiling.span(name):
        o, d = o.contiguous(), d.contiguous()
        t_max = t_max.to(torch.float32).contiguous()
        return walk(kd, o, d, t_max, _stack_depth(kd, cfg), any_hit)


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
