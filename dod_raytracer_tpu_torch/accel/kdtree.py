"""kd-tree build orchestration: host build -> device ``KDArrays``.

Counterpart of ``dod_raytracer_tpu.accel.kdtree``.  The build is host
pointer-chasing, in C++ (``native/kdtree_build.cpp``) when ``g++`` can
build it, else the numpy builder (``_kdtree_np.build``), the same tree bit
for bit; its output becomes flat tensors on the scene's device, plus the
blocked leaf layout that the traversals read:

* ``block_orig`` (B, S): original triangle id per slot of each leaf block
  (S = leaf_chunk_lanes * lane_size), -1 for empty slots;
* ``block_tris`` (B, S, 9): pre-gathered [A | B-A | C-A] rows (the
  Möller–Trumbore input of the kernels and the plain walks);
* ``block_g`` (B, 16, 5*Spad): per-block Plücker matrices (``pack_block_g``;
  the kernels and the plain walks read rows 0-5 of its edge sections);
* ``block_aabb`` (6, B): per-block vertex AABB (the kernel's block pre-test);
* ``tre_tbl`` / ``top_tbl``: the treelet forest of a tree of more than
  ``treelet_cap`` (0: ``_kdtree_np.MAX_NODES`` = 1024) nodes, the forest
  kernel's tables (``_kdtree_np.cut_treelets``).

Every tree keeps each lane's filing box (``lane_lo``, ``lane_hi``) and its
build ``Config``, and ``follow_vertices`` keeps it conservative as the
vertices move.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from . import _kdtree_np
from ..native import NativeUnavailable, kdtree_native
from ..scene import KDArrays
from ..utils.math import cross
from ..utils.profiling import count, span

logger = logging.getLogger("dod_raytracer_tpu_torch")


def host_build(tri_verts: np.ndarray, cfg):
    """The SAH tree of ``tri_verts`` under ``cfg`` -> (BuiltKD, builder):
    the native builder (``native/kdtree_build.cpp``) when its library
    builds, else the numpy builder; both give the same tree bit for bit.
    ``builder`` is "native" or "numpy"."""
    kw = dict(lane_size=cfg.lane_size, max_prims=cfg.MaxPrims, intersect_cost=float(cfg.IntersectCost),
              traversal_cost=float(cfg.TraversalCost), empty_bonus=float(cfg.EmptyBonus))
    try:
        return kdtree_native.build(tri_verts, **kw), "native"
    except NativeUnavailable:  # logged once at WARNING by native._load
        return _kdtree_np.build(tri_verts, **kw), "numpy"


# the first re-filing of a tree pads each triangle's box by PAD_STEPS times
# the root mean square move of a vertex coordinate in the step that forced
# it, so that lanes moving at that pace stay filed for about that many
# steps; at most PAD_MAX of the mesh's box diagonal, which bounds how many
# lanes straddle a split.  Later re-filings keep that padding: the number
# of leaf blocks, and with it the walks' cost, then changes only as the
# mesh does, not with each step's moves
PAD_STEPS = 8.0
PAD_MAX = 0.01


def build_kdtree(tri_verts: np.ndarray, cfg, device="cuda") -> KDArrays:
    """The reference's SAH tree of ``tri_verts`` (T, 3, 3) with its leaf
    blocks.  The tree keeps each lane's filing box and ``cfg``
    (``follow_vertices``)."""
    built, builder = host_build(tri_verts, cfg)
    num_lanes_in = (tri_verts.shape[0] + cfg.lane_size - 1) // cfg.lane_size
    logger.info(
        "kd build (%s builder): %d tris, %d nodes (%d leaves), depth %d, "
        "%d reordered lanes (dup ratio %.3f)",
        builder, tri_verts.shape[0], built.node_flag.shape[0],
        int((built.node_flag == _kdtree_np.LEAF_FLAG).sum()), built.max_depth,
        built.prim_nums.shape[0],
        built.prim_nums.shape[0] / max(num_lanes_in, 1),
    )
    return _device_tree(built, torch.from_numpy(tri_verts), _kdtree_np.lane_bounds(tri_verts, cfg.lane_size), 0.0,
                        cfg, device)


def _device_tree(built, tri_verts: torch.Tensor, lane_boxes, margin: float, cfg, device) -> KDArrays:
    """``KDArrays`` on ``device`` of a host tree ``built`` whose lanes were
    filed by ``lane_boxes`` (lo, hi), their triangles' boxes padded by
    ``margin``, with its leaf blocks of ``tri_verts``."""
    built = _kdtree_np.align_leaves(built, cfg.leaf_chunk_lanes)
    perm = _kdtree_np.perm_from_prim_nums(built.prim_nums, tri_verts.shape[0], cfg.lane_size)
    block = cfg.leaf_chunk_lanes * cfg.lane_size
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # treelet forest when the tree exceeds one table of the mega walk
    tre_tbl = top_tbl = None
    cap = int(getattr(cfg, "treelet_cap", 0)) or _kdtree_np.MAX_NODES
    if built.node_flag.shape[0] > cap:
        roots, sizes = _kdtree_np.cut_treelets(built, cap)
        tre_tbl = t(_kdtree_np.pack_treelet_tables(built, roots, sizes, cfg.leaf_chunk_lanes, cap))
        top_tbl = t(_kdtree_np.build_top_table(built, roots))

    kd = KDArrays(
        tre_tbl=tre_tbl,
        top_tbl=top_tbl,
        node_flag=t(built.node_flag),
        node_split=t(built.node_split),
        node_right=t(built.node_right),
        node_leaf_start=t(built.node_leaf_start),
        node_leaf_lanes=t(built.node_leaf_lanes),
        bounds_min=t(built.bounds_min),
        bounds_max=t(built.bounds_max),
        tri_perm=t(perm),
        block_orig=t(perm.reshape(-1, block)),
        lane_size=int(cfg.lane_size),
        num_lanes=int(built.prim_nums.shape[0]),
        max_leaf_lanes=int(built.max_leaf_lanes),
        block_lanes=int(cfg.leaf_chunk_lanes),
        max_depth=int(built.max_depth),
        lane_lo=t(lane_boxes[0]),
        lane_hi=t(lane_boxes[1]),
        margin=float(margin),
        build_cfg=cfg,
    )
    return refresh_kd_blocks(kd, tri_verts.to(device))


def lanes_left(kd: KDArrays, tri_verts: torch.Tensor) -> torch.Tensor:
    """() bool tensor: some triangle of ``tri_verts`` has a corner outside
    its lane's filing box (lanes padded with the last triangle, as
    ``_kdtree_np.lane_bounds`` pads them)."""
    v = tri_verts.detach()
    lanes = kd.lane_lo.shape[0]
    pad = lanes * kd.lane_size - v.shape[0]
    if pad:
        v = torch.cat([v, v[-1:].expand(pad, 3, 3)])
    v = v.reshape(lanes, kd.lane_size * 3, 3)
    return ((v.amin(dim=1) < kd.lane_lo) | (v.amax(dim=1) > kd.lane_hi)).any()


def follow_vertices(kd: KDArrays, old_verts: torch.Tensor, tri_verts: torch.Tensor) -> KDArrays:
    """The tree after its triangles moved from ``old_verts`` to
    ``tri_verts`` (an optimizer's update).

    A lane lies in every leaf whose closed cell its filing box meets, so
    while every triangle stays inside its lane's box, every ray whose
    segment meets a triangle visits a leaf that holds it, in every walk,
    and the root box holds every triangle.  So the leaf blocks are
    repacked (``refresh_kd_blocks``, the JAX package's update) after a
    check of the boxes (one read of a flag to the host).  Where a
    triangle has left its box, every lane is filed again on the host
    (``_kdtree_np.refile``), by its new box padded by the tree's margin,
    into the leaves of the same splits: the tree's shape, and with it the
    walks' cost, stays that of its build.  The first re-filing sets the
    margin: ``PAD_STEPS`` times the step's root mean square coordinate
    move, at most ``PAD_MAX`` of the mesh's box diagonal.
    A tree the port did not build (``scene_from_numpy``) has no filing
    boxes, and only has its blocks repacked, as in the JAX package.
    Tracer: spans ``kd.refresh`` and ``kd.rebuild``, counter
    ``kd.rebuilds`` (the re-filings)."""
    if kd.lane_lo is None:
        return refresh_kd_blocks(kd, tri_verts)
    with span("kd.refresh"):
        if not bool(lanes_left(kd, tri_verts)):
            return refresh_kd_blocks(kd, tri_verts)
    with span("kd.rebuild"):
        count("kd.rebuilds", 1)
        v = tri_verts.detach()
        margin = np.float32(kd.margin)
        if not margin:
            move = float(torch.sqrt(torch.mean(torch.square(v - old_verts.detach()))))
            diag = float(torch.linalg.vector_norm(v.amax(dim=(0, 1)) - v.amin(dim=(0, 1))))
            margin = np.float32(min(PAD_STEPS * move, PAD_MAX * diag))
        lo, hi = _kdtree_np.lane_bounds(v.cpu().numpy(), kd.lane_size)
        boxes = (lo - margin, hi + margin)
        host = lambda x: x.cpu().numpy()
        built = _kdtree_np.refile(host(kd.node_flag), host(kd.node_split), host(kd.node_right), *boxes,
                                  kd.max_depth)
        return _device_tree(built, v, boxes, margin, kd.build_cfg, v.device)


def pad_blocks(S: int) -> int:
    """Triangle-axis padding of ``block_g`` sections (128-multiple, the
    JAX package's layout, kept so the two packages' tables are equal)."""
    return ((S + 127) // 128) * 128


def pack_block_g(block_verts: torch.Tensor) -> torch.Tensor:
    """(B, S, 3, 3) block vertices -> (B, 16, 5*Spad) Plücker matrices.

    Same layout as ``dod_raytracer_tpu.ops.pallas.block_loop_kernel
    .pack_block_g``: five Spad-wide sections [s0|s1|s2|den|num]; the 16
    feature rows match the ray vector [d, o x d, o, 1, 0 x 6].  Only rows
    0-5 of s0..s2, rows 0-2 of den and rows 6-9 of num are non-zero; the
    CUDA kernel relies on that structure.  Empty slots (all-zero vertices)
    and padding give all-zero columns, which every test rejects.
    """
    B, S = block_verts.shape[:2]
    spad = pad_blocks(S)
    A = block_verts[..., 0, :]  # (B, S, 3)
    Bv = block_verts[..., 1, :]
    C = block_verts[..., 2, :]
    n = cross(Bv - A, C - A)
    z3 = torch.zeros_like(A)
    z1 = torch.zeros_like(A[..., :1])

    def col(d_rows, w_rows, o_rows, const):
        return torch.cat([d_rows, w_rows, o_rows, const, z1.expand(B, S, 6)], dim=-1)  # (B, S, 16)

    s0 = col(cross(A, Bv), Bv - A, z3, z1)
    s1 = col(cross(Bv, C), C - Bv, z3, z1)
    s2 = col(cross(C, A), A - C, z3, z1)
    den = col(n, z3, z3, z1)
    num = col(z3, z3, -n, torch.sum(n * A, dim=-1, keepdim=True))
    G = torch.stack([s0, s1, s2, den, num], dim=1)  # (B, 5, S, 16)
    if spad != S:
        G = torch.nn.functional.pad(G, (0, 0, 0, spad - S))
    G = G.transpose(2, 3)  # (B, 5, 16, Spad)
    return G.permute(0, 2, 1, 3).reshape(B, 16, 5 * spad).contiguous()


def _signed_zero_min(v: torch.Tensor) -> torch.Tensor:
    """(B, S, 3, 3) -> (B, 3) min over slots and corners, ordering -0.0
    below +0.0 as XLA's min does (torch keeps whichever zero it meets
    first), so the block AABBs are bit-equal to the JAX package's."""
    m = v.amin(dim=(1, 2))
    neg_zero = ((v == 0) & torch.signbit(v)).any(dim=2).any(dim=1)
    return torch.where(m == 0, torch.where(neg_zero, -0.0, 0.0), m)


def refresh_kd_blocks(kd: KDArrays, tri_verts: torch.Tensor) -> KDArrays:
    """(Re)materialize the blocked triangle layout from the current vertex
    tensor (after any vertex update)."""
    if kd.block_orig is None:
        return kd
    orig = kd.block_orig  # (B, S)
    valid = (orig >= 0)[..., None, None]
    verts = tri_verts.detach()[orig.clamp_min(0).long()]  # (B, S, 3, 3)
    verts = torch.where(valid, verts, 0.0)
    A = verts[..., 0, :]
    e1 = verts[..., 1, :] - A
    e2 = verts[..., 2, :] - A
    rows = torch.cat([A, e1, e2], dim=-1).contiguous()  # (B, S, 9)
    # empty slots get [+inf, -inf] so they never extend the box
    lo = torch.where(valid, verts, float("inf"))
    hi = torch.where(valid, verts, float("-inf"))
    aabb = torch.cat([_signed_zero_min(lo), -_signed_zero_min(-hi)], dim=1).T.contiguous()  # (6, B)
    return dataclasses.replace(kd, block_tris=rows, block_g=pack_block_g(verts),
                               block_aabb=aabb)
