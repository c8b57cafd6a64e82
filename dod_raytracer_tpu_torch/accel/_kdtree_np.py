"""Host-side SAH kd-tree builder (numpy).

Copy of ``dod_raytracer_tpu.accel._kdtree_np`` (``build``, ``lane_bounds``,
``align_leaves``, ``perm_from_prim_nums``, ``cut_treelets``,
``build_top_table``, ``pack_treelet_tables``): a faithful reimplementation of
the reference builder (``src/accelerators/kdtree.cpp:66-260``) over
triangle *lanes* (groups of ``lane_size`` consecutive triangles,
``triangle.h:33-44``), emitting flat arrays instead of pointer nodes:

* preorder node list where the left child is ``node + 1`` and the right
  child index is patched after the left subtree (kdtree.cpp:247-249);
* per-leaf lane lists concatenated into ``prim_nums`` with duplication of
  straddling lanes (kdtree.cpp:226-245), which becomes the leaf-contiguous
  triangle permutation (triangle.cpp:349-367) as a gather index.

Replicated reference quirks (bit-for-bit cost semantics):
* ``bestSplitCost`` is an ``unsigned`` assigned from ``float`` — each
  accepted cost is *truncated*; a candidate wins iff ``floor(cost)`` is
  strictly below the running best floor (kdtree.cpp:141,181-183).
* the empty bonus tests ``numLanesRightOfSplit`` twice (kdtree.cpp:175).
* maxDepth = round(log2(8 + 1.3 * numLanes)), half-away-from-zero
  (kdtree.cpp:72).
* axis order starts at the node bound's maximum extent with early break
  once an axis yields cost < leaf cost (kdtree.cpp:144-148,196-199).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

LEAF_FLAG = 3


@dataclasses.dataclass
class BuiltKD:
    node_flag: np.ndarray  # (M,) i32 — 0/1/2 axis, 3 leaf
    node_split: np.ndarray  # (M,) f32
    node_right: np.ndarray  # (M,) i32
    node_leaf_start: np.ndarray  # (M,) i32 — lane offset into prim_nums
    node_leaf_lanes: np.ndarray  # (M,) i32
    bounds_min: np.ndarray  # (3,) f32
    bounds_max: np.ndarray  # (3,) f32
    prim_nums: np.ndarray  # (K,) i32 — original lane index per reordered lane
    max_leaf_lanes: int
    max_depth: int


def lane_bounds(tri_verts: np.ndarray, lane_size: int):
    """Per-lane AABBs over groups of ``lane_size`` triangles
    (KDTree::init, kdtree.cpp:84-90)."""
    T = tri_verts.shape[0]
    num_lanes = (T + lane_size - 1) // lane_size
    pad = num_lanes * lane_size - T
    v = tri_verts
    if pad:
        # pad with copies of the last real triangle so padding never widens a box
        v = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
    v = v.reshape(num_lanes, lane_size, 3, 3)
    mins = v.min(axis=(1, 2)).astype(np.float32)
    maxs = v.max(axis=(1, 2)).astype(np.float32)
    return mins, maxs


def _surface_area(bmin, bmax):
    d = bmax - bmin
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def build(tri_verts: np.ndarray, lane_size: int = 8, max_prims: int = 8,
          intersect_cost: float = 80.0, traversal_cost: float = 80.0,
          empty_bonus: float = 0.0) -> BuiltKD:
    mins, maxs = lane_bounds(tri_verts, lane_size)
    num_lanes = mins.shape[0]
    world_min = mins.min(axis=0)
    world_max = maxs.max(axis=0)
    # kdtree.cpp:72 — std::round is half away from zero
    max_depth = int(math.floor(math.log2(8.0 + 1.3 * num_lanes) + 0.5))

    node_flag: list = []
    node_split: list = []
    node_right: list = []
    node_leaf_start: list = []
    node_leaf_lanes: list = []
    prim_nums: list = []
    max_leaf = 0

    def add_leaf(lanes: np.ndarray):
        nonlocal max_leaf
        node_flag.append(LEAF_FLAG)
        node_split.append(0.0)
        node_right.append(0)
        node_leaf_start.append(len(prim_nums))
        node_leaf_lanes.append(len(lanes))
        prim_nums.extend(int(x) for x in lanes)
        max_leaf = max(max_leaf, len(lanes))

    def recurse(depth: int, bad_refines: int, bmin: np.ndarray, bmax: np.ndarray,
                lanes: np.ndarray):
        # kdtree.cpp:106-111
        if depth == 0 or len(lanes) <= max_prims:
            add_leaf(lanes)
            return

        lmins = mins[lanes]
        lmaxs = maxs[lanes]
        n = len(lanes)
        original_cost = intersect_cost * n  # kdtree.cpp:142
        inv_sa = 1.0 / _surface_area(bmin, bmax)
        extent = bmax - bmin
        max_axis = int(np.argmax(extent))  # kdtree.cpp:144 (argmax first-max)

        best_floor = np.inf  # unsigned-truncation semantics: floors compared
        best_axis = -1
        best_j = -1
        best_offset = 0.0
        axis_edges = {}

        for k in range(3):
            axis = (max_axis + k) % 3  # kdtree.cpp:148
            # edge list: (offset, lane, is_end) sorted by offset; built
            # per-lane interleaved [start, end] like the reference
            # (kdtree.cpp:118-127) so stable-sort tie order matches the
            # JAX package's native C++ builder bit-for-bit
            offs = np.stack([lmins[:, axis], lmaxs[:, axis]], axis=1).reshape(-1)
            is_end = np.tile(np.array([False, True]), n)
            lane_ids = np.repeat(lanes, 2)
            order = np.argsort(offs, kind="stable")
            offs, is_end, lane_ids = offs[order], is_end[order], lane_ids[order]
            axis_edges[axis] = (offs, is_end, lane_ids)

            n_right = n - np.cumsum(is_end)  # after the pre-decrement (kdtree.cpp:157-160)
            n_left = np.concatenate([[0], np.cumsum(~is_end)[:-1]])  # post-increment :189-192
            inside = (offs >= bmin[axis]) & (offs <= bmax[axis])  # :162
            if not inside.any():
                continue
            # sliced child surface areas (kdtree.cpp:164-173)
            o1, o2 = (axis + 1) % 3, (axis + 2) % 3
            d1, d2 = extent[o1], extent[o2]
            dl = offs - bmin[axis]
            dr = bmax[axis] - offs
            sa_l = 2.0 * (dl * d1 + dl * d2 + d1 * d2)
            sa_r = 2.0 * (dr * d1 + dr * d2 + d1 * d2)
            eb = np.where(n_right == 0, empty_bonus, 0.0)  # :175 (right-only bug)
            cost = traversal_cost + intersect_cost * (1.0 - eb) * (
                sa_l * inv_sa * n_left + sa_r * inv_sa * n_right
            )
            cost = np.where(inside, cost, np.inf)
            floors = np.floor(cost)
            j = int(np.argmin(floors))  # first strict minimum == sequential scan
            if floors[j] < best_floor:
                best_floor = floors[j]
                best_axis = axis
                best_j = j
                best_offset = float(offs[j])
            if best_floor < original_cost:  # kdtree.cpp:196-199 early break
                break

        if best_floor > original_cost:  # kdtree.cpp:202-205
            bad_refines += 1
        if best_axis < 0 or bad_refines == 3 or (
            best_floor > 4 * original_cost and n < 16
        ):  # kdtree.cpp:208-214
            add_leaf(lanes)
            return

        offs, is_end, lane_ids = axis_edges[best_axis]
        # partition (kdtree.cpp:229-244): Starts strictly left of split edge,
        # Ends strictly right of it; straddlers land in both children.
        left_lanes = lane_ids[:best_j][~is_end[:best_j]]
        right_lanes = lane_ids[best_j + 1:][is_end[best_j + 1:]]
        assert len(left_lanes) + len(right_lanes) >= n, "split lost primitives"

        my_idx = len(node_flag)
        node_flag.append(best_axis)
        node_split.append(best_offset)
        node_right.append(0)  # patched below
        node_leaf_start.append(0)
        node_leaf_lanes.append(0)

        lmax = bmax.copy()
        lmax[best_axis] = best_offset
        rmin = bmin.copy()
        rmin[best_axis] = best_offset
        recurse(depth - 1, bad_refines, bmin, lmax, left_lanes)
        node_right[my_idx] = len(node_flag)  # kdtree.cpp:248
        recurse(depth - 1, bad_refines, rmin, bmax, right_lanes)

    recurse(max_depth, 0, world_min.astype(np.float64), world_max.astype(np.float64),
            np.arange(num_lanes, dtype=np.int64))

    return BuiltKD(
        node_flag=np.asarray(node_flag, np.int32),
        node_split=np.asarray(node_split, np.float32),
        node_right=np.asarray(node_right, np.int32),
        node_leaf_start=np.asarray(node_leaf_start, np.int32),
        node_leaf_lanes=np.asarray(node_leaf_lanes, np.int32),
        bounds_min=world_min.astype(np.float32),
        bounds_max=world_max.astype(np.float32),
        prim_nums=np.asarray(prim_nums, np.int32),
        max_leaf_lanes=int(max_leaf),
        max_depth=max_depth,
    )


def refile(node_flag: np.ndarray, node_split: np.ndarray, node_right: np.ndarray, mins: np.ndarray,
           maxs: np.ndarray, max_depth: int) -> BuiltKD:
    """The tree of splits ``node_*`` (a build's, in its preorder: the left
    child of interior node i is i + 1) with every lane filed again by its
    box ``mins``, ``maxs`` (L, 3): into each leaf whose closed cell the
    box meets (left where its low side is at most the split, right where
    its high side is at least it); the root bounds are the boxes' union."""
    leaves: dict = {}

    def rec(i: int, lanes: np.ndarray):
        axis = int(node_flag[i])
        if axis == LEAF_FLAG:
            leaves[i] = lanes
            return
        split = node_split[i]
        rec(i + 1, lanes[mins[lanes, axis] <= split])
        rec(int(node_right[i]), lanes[maxs[lanes, axis] >= split])

    rec(0, np.arange(mins.shape[0]))
    starts = np.zeros(node_flag.shape[0], np.int32)
    counts = np.zeros(node_flag.shape[0], np.int32)
    prims: list = []
    for i in sorted(leaves):
        starts[i], counts[i] = len(prims), len(leaves[i])
        prims.extend(leaves[i].tolist())
    return BuiltKD(
        node_flag=node_flag, node_split=node_split, node_right=node_right, node_leaf_start=starts,
        node_leaf_lanes=counts, bounds_min=mins.min(axis=0), bounds_max=maxs.max(axis=0),
        prim_nums=np.asarray(prims, np.int32), max_leaf_lanes=int(counts.max()), max_depth=max_depth,
    )


def align_leaves(built: BuiltKD, chunk_lanes: int) -> BuiltKD:
    """Re-emit the leaf lane lists so every leaf starts on a chunk_lanes
    boundary and occupies a multiple of chunk_lanes lanes (padding lane id
    -1 = empty).  This makes every traversal chunk fetch exactly one
    contiguous triangle *block*, which the traversal pre-materializes as
    (B, chunk_lanes*lane_size, 9) rows — one contiguous row-gather per ray
    per step instead of 64 scattered 36-byte rows."""
    new_prims: list = []
    starts = np.zeros_like(built.node_leaf_start)
    lanes = np.zeros_like(built.node_leaf_lanes)
    for i in range(built.node_flag.shape[0]):
        if built.node_flag[i] != LEAF_FLAG:
            continue
        s = built.node_leaf_start[i]
        c = built.node_leaf_lanes[i]
        chunk = built.prim_nums[s:s + c].tolist()
        pad = (-c) % chunk_lanes
        chunk += [-1] * pad
        starts[i] = len(new_prims)
        lanes[i] = len(chunk)
        new_prims.extend(chunk)
    return BuiltKD(
        node_flag=built.node_flag, node_split=built.node_split,
        node_right=built.node_right, node_leaf_start=starts,
        node_leaf_lanes=lanes, bounds_min=built.bounds_min,
        bounds_max=built.bounds_max,
        prim_nums=np.asarray(new_prims, np.int32),
        max_leaf_lanes=int(((built.max_leaf_lanes + chunk_lanes - 1) // chunk_lanes) * chunk_lanes),
        max_depth=built.max_depth,
    )


def perm_from_prim_nums(prim_nums: np.ndarray, num_tris: int, lane_size: int) -> np.ndarray:
    """Expand reordered lane indices to a flat triangle gather index
    (reorderLanesByIndices as a permutation-with-duplication); slots past
    the real triangle count get -1 (degenerate padding)."""
    base = prim_nums.astype(np.int64)[:, None] * lane_size + np.arange(lane_size)[None, :]
    flat = base.reshape(-1)
    flat = np.where((flat >= 0) & (flat < num_tris) & np.repeat(prim_nums >= 0, lane_size), flat, -1)
    return flat.astype(np.int32)


def cut_treelets(built: BuiltKD, cap: int):
    """Cut the preorder node array into root-disjoint subtrees ("treelets")
    of <= cap nodes each, for the two-level forest walk.

    Nodes are emitted in preorder (``build`` appends parent, then the whole
    left subtree, then the right), so subtree(i) = [i, i+size(i)) is
    contiguous and a treelet is a plain slice.  Interior nodes *above* the
    cuts become the compact "top tree" (``build_top_table``) whose leaves
    are the treelet roots; the two-level walk carries the exact intervals
    the single-tree walk would have used.

    Returns (roots (T,) i64, sizes (T,) i64) in preorder (= ascending
    node-index) order.
    """
    M = built.node_flag.shape[0]
    size = np.ones(M, np.int64)
    for i in range(M - 1, -1, -1):  # reverse preorder: children first
        if built.node_flag[i] != LEAF_FLAG:
            size[i] = 1 + size[i + 1] + size[built.node_right[i]]
    roots, sizes = [], []
    stack = [0]
    while stack:
        i = stack.pop()
        if size[i] <= cap:
            roots.append(i)
            sizes.append(int(size[i]))
            continue
        stack.append(int(built.node_right[i]))
        stack.append(i + 1)
    return np.asarray(roots, np.int64), np.asarray(sizes, np.int64)


TOP_LEAF_FLAG = 4  # top-table row that refers to a treelet ("super-leaf")
# the JAX package's one-table gate (traverse_kernel.py MAX_NODES): the
# backend dispatch sends "mega" on bigger trees elsewhere, and trees of
# more nodes than treelet_cap (0: this) get treelet tables
MAX_NODES = 1024


def _rows(ints: np.ndarray, split: np.ndarray) -> np.ndarray:
    """int32 columns with column 1 replaced by the f32 split, as one f32
    array whose int columns are bit-cast (the CUDA kernels' row format)."""
    out = np.ascontiguousarray(ints, dtype=np.int32)
    out[..., 1] = np.asarray(split, np.float32).view(np.int32)
    return out.view(np.float32)


def build_top_table(built: BuiltKD, roots: np.ndarray) -> np.ndarray:
    """Compact preorder table of the interior nodes ABOVE the treelet cuts,
    with each cut root replaced by a super-leaf row pointing at its treelet.

    (Ttop, 4) f32 rows [flag | split | right_top | tre_id], int columns
    bit-cast: flag 0/1/2 = split axis (interior), TOP_LEAF_FLAG = super-leaf
    whose tre_id indexes the treelet tables.  Preorder is preserved under
    restriction to top nodes, so the left child is still ``row + 1`` and
    only the right link is rebased.  The JAX package stores the same
    values as floats in (max(128, Ttop rounded up to 128), 128) rows for
    its TPU matmul fetch; the rows past Ttop are zero there.
    """
    root_to_tre = {int(r): t for t, r in enumerate(np.asarray(roots))}
    ints: list = []
    split: list = []

    def rec(i: int) -> int:
        my = len(ints)
        tre = root_to_tre.get(i)
        if tre is not None:
            ints.append([TOP_LEAF_FLAG, 0, 0, tre])
            split.append(0.0)
            return my
        ints.append([int(built.node_flag[i]), 0, 0, 0])
        split.append(built.node_split[i])
        rec(i + 1)
        ints[my][2] = rec(int(built.node_right[i]))
        return my

    rec(0)
    return _rows(np.asarray(ints, np.int32), np.asarray(split, np.float32))


def pack_treelet_tables(built: BuiltKD, roots, sizes, block_lanes: int,
                        cap: int) -> np.ndarray:
    """(T, cap, 6) f32 node tables, one row per node of each treelet:
    [flag | split | right_local | leaf_start | leaf_lanes | block0], int
    columns bit-cast.  Child indices are treelet-local (left = local+1 by
    preorder, right rebased; 0 at leaves); leaf_start and block0 =
    leaf_start // block_lanes stay global.  Rows past a treelet's size
    are zero.  The same columns, as floats in 128-wide rows, are the JAX
    package's (T, cap, 128) tables."""
    T = len(roots)
    ints = np.zeros((T, cap, 6), np.int32)
    split = np.zeros((T, cap), np.float32)
    for t in range(T):
        r, sz = int(roots[t]), int(sizes[t])
        sl = slice(r, r + sz)
        flag = built.node_flag[sl]
        interior = flag != LEAF_FLAG
        ints[t, :sz, 0] = flag
        ints[t, :sz, 2] = np.where(interior, built.node_right[sl] - r, 0)
        ints[t, :sz, 3] = built.node_leaf_start[sl]
        ints[t, :sz, 4] = built.node_leaf_lanes[sl]
        ints[t, :sz, 5] = built.node_leaf_start[sl] // max(block_lanes, 1)
        split[t, :sz] = built.node_split[sl]
    return _rows(ints, split)


def _wide_rows(rows: np.ndarray, int_cols) -> np.ndarray:
    out = rows.copy()
    ints = rows.view(np.int32)
    for c in int_cols:
        out[..., c] = ints[..., c].astype(np.float32)
    return out


def _narrow_rows(wide: np.ndarray) -> np.ndarray:
    # exact: the int columns hold integers below 2^24
    return _rows(wide.astype(np.int32), wide[..., 1])


def tables_to_jax(tre_tbl: np.ndarray, top_tbl: np.ndarray):
    """The port's (T, cap, 6) / (Ttop, 4) tables -> the JAX package's
    (T, cap, 128) / (max(128, Ttop up to a 128 multiple), 128) float rows."""
    T, cap, _ = tre_tbl.shape
    tre = np.zeros((T, cap, 128), np.float32)
    tre[..., :6] = _wide_rows(tre_tbl, (0, 2, 3, 4, 5))
    ttop = top_tbl.shape[0]
    top = np.zeros((max(128, -(-ttop // 128) * 128), 128), np.float32)
    top[:ttop, :4] = _wide_rows(top_tbl, (0, 2, 3))
    return tre, top


def tables_from_jax(tre_wide: np.ndarray, top_wide: np.ndarray):
    """Inverse of ``tables_to_jax``.  The top tree is binary over its T
    super-leaves, so it has 2T - 1 rows."""
    ttop = 2 * tre_wide.shape[0] - 1
    return _narrow_rows(tre_wide[..., :6]), _narrow_rows(top_wide[:ttop, :4])
