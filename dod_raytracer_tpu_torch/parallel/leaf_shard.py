"""Leaf-sharded scenes: the triangles and kd tree split over an 'mp' axis.

Counterpart of ``dod_raytracer_tpu.parallel.leaf_shard`` (the
model-parallel analogue of "scene replicated or leaf-sharded in HBM").
The triangle soup is Morton-ordered by centroid and cut into ``nmp``
equal contiguous shards (zero triangles pad the last), so that each shard
covers a compact region of space.  Each rank of an mp group builds the kd
tree of its own shard only, with the monolithic build's layout (aligned
leaves, packed leaf blocks), and walks it with the port's kernels.  JAX
stacks the shards along a leading device axis for ``shard_map``; a rank
here holds one shard, and ``Scene.shard`` (``LeafShard``) holds its
process group, its place and what every rank of the group must see
alike: the whole sharded tree's bounds, blocks and nodes.

The combine (``sharded_triangles_closest``) is positional: the mp ranks
hold the same rays in the same order, so every ray permutation of the
render (the bounce and shadow sorts) is decided from that shared data,
never from a rank's own shard (``render._sort_keys``,
``render._sort_bounces``, ``shading._sort_shadow``).  Each rank walks its
shard without gradient; an all-reduce MIN of t and then of the global
triangle index (the lowest wins a tie, as in JAX) names each ray's owner;
the owner recomputes the hit with gradient, and t, normal and colour are
combined by a masked all-reduce SUM whose backward is the identity
(``_SumOverShards``, Megatron's reduce from the model-parallel region):
every mp rank holds the same cotangent of the replicated result, and the
owner must receive it once.  The rays (and the mesh colours) enter the
owner's recompute through the converse pair (``_CopyToShards``,
Megatron's copy to the region: identity forward, all-reduce SUM
backward): the part of a ray's cotangent that flows through a hit's t
and barycentrics exists on the owner only, and the earlier bounces that
made the ray, whose triangles other ranks may own, need it on every
rank.  JAX's ``psum`` transposes
to a sum, which scales its vertex gradient by the mp size, and it takes
t from the ``pmin`` of the walk, which carries no gradient; the port's 2D
step is held to the unsharded gradient instead.

Under ``remat_bounces`` a bounce's recompute reads the winners back
(``intersect.remember``) and issues the SUM again in the backward.  The
backward's collectives (these and the rays' SUMs) pair up across ranks
because every rank of a group runs the same graph in the same order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..accel import _kdtree_np
from ..accel.kdtree import refresh_kd_blocks
from ..camera import primary_rays
from ..intersect import remember
from ..ops.ray import INF, FamilyHit
from ..ops.triangle import triangle_hit_attrs
from ..scene import KDArrays, Triangles, scene_from_numpy
from .multihost import Mesh
from .sharding import _pad_to, local_rows, render_share, tiled_loss_backward

_BIG_I32 = 2**31 - 1


@dataclasses.dataclass
class CommStats:
    """The combine's collectives since the counts were set: calls, bytes
    (each tensor once a call) and host seconds, synchronized around each
    call (gloo waits for the tensor's device work anyway; NCCL would not)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


@dataclasses.dataclass
class LeafShard:
    """A rank's part of a leaf-sharded scene (``Scene.shard``)."""

    axis: str  # the mesh axis name (cfg.tri_shard_axis)
    group: Any  # the process group of that axis's ranks (this one's mp column)
    index: int  # this rank's shard
    size: int  # shards in the group
    offset: int  # global index of this shard's first triangle
    bounds_min: torch.Tensor  # (3,) the whole sharded tree's world bounds
    bounds_max: torch.Tensor
    n_blocks: int  # leaf blocks of every shard's tree
    n_nodes: int  # nodes of every shard's tree
    stats: Optional[CommStats] = None  # set: the combine counts its collectives


def _morton_order(tv: np.ndarray) -> np.ndarray:
    """Z-curve order of triangle centroids (10 bits/axis): a spatial sort
    whose equal contiguous chunks are compact regions of space."""
    c = tv.mean(axis=1)
    span = np.maximum(c.max(0) - c.min(0), 1e-30)
    q = np.clip(((c - c.min(0)) / span * 1023.0), 0, 1023).astype(np.uint64)
    code = np.zeros(c.shape[0], np.uint64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return np.argsort(code, kind="stable")


def build_leaf_sharded_triangles(tv: np.ndarray, tn: np.ndarray, tm: np.ndarray, cfg, nmp: int,
                                 mp_index: int, device="cuda"):
    """Shard ``mp_index`` of ``nmp`` of the Morton-ordered soup (global
    triangle i is ``_morton_order(tv)[i]``): its triangles and the kd tree
    of them alone (``_kdtree_np.build``, ``align_leaves``, ``perm_from_prim_nums``,
    the packed leaf blocks of ``accel.kdtree.refresh_kd_blocks``; no
    treelet tables, as in JAX) -> (Triangles, KDArrays, shard size).  Its
    tables equal the unpadded part of JAX's stacked slice ``mp_index``."""
    order = _morton_order(tv)
    tv, tn, tm = tv[order], tn[order], tm[order]
    shard = -(-tv.shape[0] // nmp)
    pad = shard * nmp - tv.shape[0]
    if pad:  # zero triangles, which every test rejects, fill the last shard
        tv = np.concatenate([tv, np.zeros((pad, 3, 3), np.float32)], 0)
        tn = np.concatenate([tn, np.zeros((pad, 3, 3), np.float32)], 0)
        tm = np.concatenate([tm, np.zeros((pad,), np.int32)], 0)
    sl = slice(mp_index * shard, (mp_index + 1) * shard)
    b = _kdtree_np.build(tv[sl], lane_size=cfg.lane_size, max_prims=cfg.MaxPrims,
                         intersect_cost=float(cfg.IntersectCost), traversal_cost=float(cfg.TraversalCost),
                         empty_bonus=float(cfg.EmptyBonus))
    b = _kdtree_np.align_leaves(b, cfg.leaf_chunk_lanes)
    perm = _kdtree_np.perm_from_prim_nums(b.prim_nums, shard, cfg.lane_size)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tris = Triangles(verts=t(tv[sl]), normals=t(tn[sl]), mesh_id=t(tm[sl]))
    kd = KDArrays(
        node_flag=t(b.node_flag), node_split=t(b.node_split), node_right=t(b.node_right),
        node_leaf_start=t(b.node_leaf_start), node_leaf_lanes=t(b.node_leaf_lanes),
        bounds_min=t(b.bounds_min), bounds_max=t(b.bounds_max), tri_perm=t(perm),
        block_orig=t(perm.reshape(-1, cfg.leaf_chunk_lanes * cfg.lane_size)),
        lane_size=int(cfg.lane_size), num_lanes=int(b.prim_nums.shape[0]),
        max_leaf_lanes=int(b.max_leaf_lanes), block_lanes=int(cfg.leaf_chunk_lanes),
        max_depth=int(b.max_depth))
    return tris, refresh_kd_blocks(kd, tris.verts), shard


def make_leaf_sharded_scene(builder, cfg, mesh: Mesh, mp_axis: str = "mp", device="cuda"):
    """This rank's leaf-sharded Scene: every family but the triangles as
    ``builder.build`` makes it (no monolithic kd tree), the triangles and
    tree of shard ``mesh.coords[mp_axis]``, and its ``LeafShard`` (two
    all-reduces over the mp group give the whole tree's bounds and size).
    Every rank of the group calls it with the same builder."""
    scene = builder.build(dataclasses.replace(cfg, use_kdtree=False), device=device)
    cat = lambda parts, empty: np.concatenate(parts, 0) if parts else empty
    tv = cat(builder._tri_verts, np.zeros((1, 3, 3), np.float32))
    tn = cat(builder._tri_normals, np.zeros((1, 3, 3), np.float32))
    tm = cat(builder._tri_mesh, np.zeros((1,), np.int32))
    nmp, index, group = mesh.shape[mp_axis], mesh.coords[mp_axis], mesh.groups[mp_axis]
    tris, kd, shard = build_leaf_sharded_triangles(tv, tn, tm, cfg, nmp, index, device)
    box = torch.cat([-kd.bounds_min, kd.bounds_max])
    dist.all_reduce(box, op=dist.ReduceOp.MAX, group=group)
    size = torch.tensor([kd.block_orig.shape[0], kd.node_flag.shape[0]], dtype=torch.int64, device=device)
    dist.all_reduce(size, op=dist.ReduceOp.SUM, group=group)
    leaf = LeafShard(axis=mp_axis, group=group, index=index, size=nmp, offset=index * shard,
                     bounds_min=-box[:3], bounds_max=box[3:], n_blocks=int(size[0]), n_nodes=int(size[1]))
    return dataclasses.replace(scene, triangles=tris, kd=kd, shard=leaf)


def _tree_nodes(flag: np.ndarray, right: np.ndarray) -> int:
    """Nodes reachable from the root of a padded node table (JAX pads the
    stacked tables with leaves no node points to)."""
    stack, n = [0], 0
    while stack:
        i = stack.pop()
        n += 1
        if flag[i] != _kdtree_np.LEAF_FLAG:
            stack += [i + 1, int(right[i])]
    return n


def local_scene_from_numpy(arrays: dict, mp_index: int, group, device="cuda", axis: str = "mp"):
    """Rank ``mp_index``'s leaf-sharded Scene from the JAX package's
    stacked one (``make_leaf_sharded_scene``) as numpy arrays (nested like
    ``scene.scene_from_numpy``'s input): slice ``mp_index`` of every
    triangle and kd table, padding kept (no node or block reaches it), and
    the whole tree's bounds, blocks and nodes counted from every slice."""
    kd_all = arrays["kd"]
    tri = {k: v[mp_index] for k, v in arrays["triangles"].items()}
    kd = {k: v[mp_index] if isinstance(v, np.ndarray) else v for k, v in kd_all.items()}
    scene = scene_from_numpy(dict(arrays, triangles=tri, kd=kd), device)
    nmp, shard = arrays["triangles"]["verts"].shape[:2]
    n_blocks = int((kd_all["block_orig"] >= 0).any(axis=-1).sum())
    n_nodes = sum(_tree_nodes(kd_all["node_flag"][s], kd_all["node_right"][s]) for s in range(nmp))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    leaf = LeafShard(axis=axis, group=group, index=mp_index, size=int(nmp), offset=mp_index * int(shard),
                     bounds_min=t(kd_all["bounds_min"].min(0)), bounds_max=t(kd_all["bounds_max"].max(0)),
                     n_blocks=n_blocks, n_nodes=n_nodes)
    return dataclasses.replace(scene, shard=leaf)


# A rank holds one shard: refreshing its blocks after a vertex update is
# the monolithic refresh (JAX vmaps it over the stacked shards).
refresh_kd_blocks_stacked = refresh_kd_blocks


# --------------------------------------------------------------------------
# the combine
# --------------------------------------------------------------------------

def _all_reduce(x, op, shard: LeafShard):
    """``x`` all-reduced in place over the shard group, counted in
    ``shard.stats`` when set."""
    stats = shard.stats
    if stats is None:
        dist.all_reduce(x, op=op, group=shard.group)
        return x
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t = time.perf_counter()
    dist.all_reduce(x, op=op, group=shard.group)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    stats.calls += 1
    stats.bytes += x.numel() * x.element_size()
    stats.seconds += time.perf_counter() - t
    return x


class _CopyToShards(torch.autograd.Function):
    """Forward: the identity.  Backward: all-reduce SUM over the shard
    group.  The rays are replicated, but the part of their cotangent that
    flows through a hit's recompute exists on the hit's owner only, and
    every rank's earlier bounces need all of it (module docstring)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), dist.ReduceOp.SUM, ctx.shard), None


class _SumOverShards(torch.autograd.Function):
    """Forward: all-reduce SUM over the shard group.  Backward: the
    identity, since each rank already holds the whole cotangent of the
    replicated sum (module docstring)."""

    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(x.clone(), dist.ReduceOp.SUM, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@torch.no_grad()
def _winner(scene, o, d, t_max, cfg, shard: LeafShard):
    """-> (local triangle per ray, True where this rank owns the ray's
    closest hit, True where some shard hit): the local walk, then the
    all-reduce MIN of t and of the global index among the contenders
    (JAX ``leaf_shard.py:211-231``)."""
    from ..ops.traverse import kd_closest

    t_loc, idx_loc, hit_loc = kd_closest(scene.kd, scene.triangles, o, d, t_max, cfg)
    t_loc = torch.where(hit_loc, t_loc, INF)
    t_min = _all_reduce(t_loc.clone(), dist.ReduceOp.MIN, shard)
    contend = hit_loc & (t_loc == t_min)
    gidx = torch.where(contend, idx_loc.to(torch.int32) + shard.offset, _BIG_I32)
    gidx_min = _all_reduce(gidx.clone(), dist.ReduceOp.MIN, shard)
    return idx_loc, contend & (gidx == gidx_min), t_min < INF


def sharded_triangles_closest(scene, o, d, t_max, cfg, axis: str, saved=None) -> FamilyHit:
    """The closest triangle hit over every shard of the group (module
    docstring); ``scene`` holds this rank's shard.  ``saved``: see
    ``intersect.remember``."""
    shard = scene.shard
    idx, mine, found = remember(saved, "triangles", lambda: _winner(scene, o, d, t_max, cfg, shard))
    # the replicated inputs of the owner's recompute (alike on every rank, so is requires_grad)
    if o.requires_grad or d.requires_grad:
        od = _CopyToShards.apply(torch.cat([o, d], dim=1), shard)
        o, d = od[:, :3], od[:, 3:]
    colors = scene.mesh_colors
    if colors.requires_grad:
        colors = _CopyToShards.apply(colors, shard)
    fh = triangle_hit_attrs(scene.triangles, o, d, idx, mine, colors)
    own = torch.where(mine[:, None], torch.cat([fh.t[:, None], fh.normal, fh.color], dim=1), 0.0)
    hit = _SumOverShards.apply(own, shard)
    return FamilyHit(t=torch.where(found, hit[:, 0], INF), normal=hit[:, 1:4], color=hit[:, 4:7])


@torch.no_grad()
def sharded_triangles_occluded(scene, o, d, t_max, cfg, axis: str) -> torch.Tensor:
    """Any-hit over every shard: the local walk's bits, all-reduced MAX."""
    from ..ops.traverse import kd_any

    blocked = kd_any(scene.kd, scene.triangles, o, d, t_max, cfg).to(torch.int32)
    return _all_reduce(blocked, dist.ReduceOp.MAX, scene.shard) > 0


# --------------------------------------------------------------------------
# the 2D (dp, mp) step and the full-frame render
# --------------------------------------------------------------------------

def _check_axis(cfg, mp_axis: str) -> None:
    if getattr(cfg, "tri_shard_axis", "") != mp_axis:
        raise ValueError(f"set cfg.tri_shard_axis to the mp axis name {mp_axis!r}")


def loss_and_vertex_grads_2d(scene, target_flat, cfg, mesh: Mesh, dp_axis: str = "dp", mp_axis: str = "mp"):
    """Pixel loss and this rank's shard's vertex gradient on a (dp, mp)
    mesh -> (loss, grad of ``scene.triangles.verts``).  The rays and the
    target are sharded over dp (padded by repeating the last ray, as
    ``sharding._pad_to``; JAX pads with zero rays here); each rank
    backprops its dp share's loss over the global pixel count, and the
    loss and the gradient are all-reduced (SUM) over dp only: no vertex
    tensor is gathered."""
    _check_axis(cfg, mp_axis)
    k, group = mesh.shape[dp_axis], mesh.groups[dp_axis]
    o, d, d_raw = primary_rays(cfg.Width, cfg.Height, device=scene.device)
    o, d, d_raw, target = (local_rows(_pad_to(x, k)[0], mesh, dp_axis) for x in (o, d, d_raw, target_flat))
    verts = scene.triangles.verts.detach().clone().requires_grad_(True)
    local = dataclasses.replace(scene, triangles=dataclasses.replace(scene.triangles, verts=verts))
    loss = tiled_loss_backward(local, cfg, o, d, d_raw, target, float(target.numel() * k))
    grad = torch.zeros_like(verts) if verts.grad is None else verts.grad
    for x in (grad, loss):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return loss, grad


def make_train_step_2d(cfg, mesh: Mesh, dp_axis: str = "dp", mp_axis: str = "mp", lr: float = 0.1):
    """The inverse-rendering step on a (dp, mp) mesh: ``step(scene,
    target_flat) -> (loss, new_scene)``, each rank's shard of the vertices
    moved along its gradient (``loss_and_vertex_grads_2d``) and its leaf
    blocks refreshed from them."""

    def step(scene, target_flat):
        loss, grad = loss_and_vertex_grads_2d(scene, target_flat, cfg, mesh, dp_axis, mp_axis)
        verts = scene.triangles.verts - lr * grad
        return loss, dataclasses.replace(scene, triangles=dataclasses.replace(scene.triangles, verts=verts),
                                         kd=refresh_kd_blocks_stacked(scene.kd, verts))

    return step


def render_image_leaf_sharded(scene, cfg, mesh: Mesh, dp_axis: str = "dp", mp_axis: str = "mp"):
    """Full-frame render on a (dp, mp) mesh: rays sharded over dp (padded
    with o = 0, d = (0, 0, 1), as JAX), triangles and tree over mp, the
    other families replicated -> (H, W, 3) on every rank."""
    _check_axis(cfg, mp_axis)
    o, d, d_raw = primary_rays(cfg.Width, cfg.Height, device=scene.device)
    n, pad = o.shape[0], (-o.shape[0]) % mesh.shape[dp_axis]
    if pad:
        fill = torch.tensor([[0.0, 0.0, 1.0]], device=o.device).expand(pad, 3)
        o = torch.cat([o, torch.zeros((pad, 3), device=o.device)])
        d, d_raw = torch.cat([d, fill]), torch.cat([d_raw, fill])
    return render_share(scene, cfg, mesh, dp_axis, o, d, d_raw)[:n].reshape(cfg.Height, cfg.Width, 3)
