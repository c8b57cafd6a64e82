"""The binned kd walk: its CUDA leaf stage (``csrc/block_loop.cu``) and
its CUDA descend round (``csrc/binned_descend.cu``).

Counterpart of ``dod_raytracer_tpu.ops.pallas.block_loop_kernel``
(``block_loop_intersect``) and of the JAX package's binned traversal
(``traverse.py`` ``_traverse_binned``), which ``_backend`` picks for
``"binned"``, and for ``"mega"`` on a tree of more than ``MAX_NODES``
nodes.  The JAX package runs the walk as one on-device ``while_loop``
whose body is the descend (an inner ``while_loop``) and one kernel launch
over every ray of the batch.  On CUDA tensors the port runs each round
as two launches and one host read: ``descend`` (the round kernel: fold the
last leaf result, descend each active ray to its next leaf, write its
block key, count the active rays), then ``block_loop_intersect`` over
every ray (key -1: no block this round), then one read of the active
count; the walk ends when it is 0.  CPU tensors take the plain walk,
``traverse._walk`` with ``leaf_plain`` as its leaf stage.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors: ``leaf_plain`` for the block loop,
``descend_plain`` for the round.  Every launch adds one to its count
(``launches``, ``descend_launches``; by the walk's mode); nothing else
does.  ``block_loop_per_ray`` (the one thread per ray it replaced) is for
measurement only, with its own count; the walk never calls it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..accel._kdtree_np import LEAF_FLAG
from . import _cuda
from .aabb import slab_test
from .traverse import _pack_nodes, _walk, leaf_plain

NAME = "block_loop"
DESCEND = "binned_descend"
# per-launch counts of the block loop's measurement build:
# [warps with a key, distinct keys summed over warps, CTAs with a key,
# distinct keys summed over CTAs]
KEY_COUNTS = ("warps", "warp_keys", "ctas", "cta_keys")

# kernel launches by mode of the walk that made them, counted where each
# kernel is launched
launches = {"closest": 0, "any_hit": 0}
descend_launches = {"closest": 0, "any_hit": 0}
per_ray_launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for counts in (launches, descend_launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def _fn():
    return _cuda.library(NAME, "dod_block_loop", [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _fn_per_ray():
    return _cuda.library(NAME, "dod_block_loop_per_ray",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _fn_descend():
    return _cuda.library(DESCEND, "dod_binned_descend",
                         [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _check(kd, o, d):
    """The tables and rays a launch reads, for CUDA tensors; the staged
    kernels read 4 slots at a time from 16-byte aligned rows of block_g."""
    n = o.shape[0]
    dev = o.device
    _cuda.check_count(n)
    _cuda.check_blocks(kd, ("block_orig", "block_tris", "block_g"), dev)
    _cuda.check("o", o, torch.float32, (n, 3), dev)
    _cuda.check("d", d, torch.float32, (n, 3), dev)
    S, spad = kd.block_orig.shape[1], kd.block_g.shape[2] // 5
    if S % 4 or spad % 4:
        raise ValueError(f"the block loop reads 4 slots at a time: slots {S}, spad {spad}")
    if kd.block_g.data_ptr() % 16:
        raise ValueError("block_g is not 16-byte aligned")


def _check_keys(kd, o, keys, stats, touched, key_counts):
    n = o.shape[0]
    _cuda.check("keys", keys, torch.int32, (n,), o.device)
    _cuda.check_marks(kd, stats, touched, n, 2, o.device)
    if key_counts is not None:
        if stats is None:
            raise ValueError("key_counts is written only by the stats build: pass stats too")
        _cuda.check("key_counts", key_counts, torch.int32, (len(KEY_COUNTS),), o.device)


def _launch(kd, o, d, keys, mode: str, stats=None, touched=None, key_counts=None):
    """One launch of the render path's kernel on checked inputs -> (t, prim)."""
    n = o.shape[0]
    dev = o.device
    B, S = kd.block_orig.shape
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, prim
    ptr = lambda x: 0 if x is None else x.data_ptr()
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(),
                 keys.data_ptr(), o.data_ptr(), d.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 ptr(stats), ptr(touched), ptr(key_counts), n, B, S, kd.block_g.shape[2] // 5,
                 _cuda.stream_of(dev))
    _cuda.raise_on(err, NAME)
    launches[mode] += 1
    return t_out, prim


def block_loop_intersect(kd, o, d, keys, mode: str = "closest", stats=None, touched=None, key_counts=None):
    """The closest hit of each ray in block ``keys[i]`` -> (t (N,) f32,
    prim (N,) i32); (inf, 2**30) where the block holds no hit or the key is
    outside [0, B).

    ``mode`` ("closest" or "any_hit", the walk's mode) only names the count
    the launch adds to: the result is the block's first strict-minimum hit
    in both.  CUDA tensors need ``block_g``, ``block_tris`` and
    ``block_orig`` (slots and spad multiples of 4, block_g 16-byte
    aligned), and int32 keys.  ``stats``, ``touched`` and ``key_counts``
    are for measurement only: an optional (N, 2) int32 CUDA tensor into
    which a separate build writes each ray's non-empty slots edge-tested
    and distances computed; an optional (B, 2 + S) int32 one, zeroed by the
    caller, in which it marks the blocks edge-tested (column 1) and the
    slots whose triangle row it read (column 2 + j); and an optional (4,)
    int32 one, zeroed by the caller, to which it adds ``KEY_COUNTS``.
    """
    if o.device.type == "cpu":
        return leaf_plain(kd, o, d, keys)
    if o.device.type != "cuda":
        raise ValueError(f"block_loop_intersect runs on cuda or cpu tensors, got {o.device}")
    if mode not in launches:
        raise ValueError(f"mode {mode!r} is not one of {list(launches)}")
    _check(kd, o, d)
    _check_keys(kd, o, keys, stats, touched, key_counts)
    return _launch(kd, o, d, keys, mode, stats, touched, key_counts)


def block_loop_per_ray(kd, o, d, keys, mode: str = "closest", stats=None, touched=None):
    """The same function by the kernel it replaced (one thread per ray, the block's
    rows read through L2), for measurement only; ``stats`` and ``touched``
    as for ``block_loop_intersect``."""
    if o.device.type == "cpu":
        return leaf_plain(kd, o, d, keys)
    if o.device.type != "cuda":
        raise ValueError(f"block_loop_per_ray runs on cuda or cpu tensors, got {o.device}")
    if mode not in per_ray_launches:
        raise ValueError(f"mode {mode!r} is not one of {list(per_ray_launches)}")
    _check(kd, o, d)
    _check_keys(kd, o, keys, stats, touched, None)
    n = o.shape[0]
    B, S = kd.block_orig.shape
    t_out = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return t_out, prim
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(o.device):
        err = _fn_per_ray()(kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(),
                            keys.data_ptr(), o.data_ptr(), d.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                            ptr(stats), ptr(touched), n, B, S, kd.block_g.shape[2] // 5, _cuda.stream_of(o.device))
    _cuda.raise_on(err, "block_loop_per_ray")
    per_ray_launches[mode] += 1
    return t_out, prim


# ---------------------------------------------------------------------------
# The walk's rounds.


@dataclasses.dataclass
class WalkState:
    """The binned walk's per-ray state, as the round kernel reads and
    writes it: (N,) int32 ``node``, ``sp``, ``cursor``, ``prim``, ``found``,
    ``active`` and f32 ``tmin``, ``tmax``, ``t_best``; the (depth, N)
    stack, node int32 and tmin, tmax f32 (depth first, so that a warp's
    accesses are coalesced); ``keys`` (N,) int32, each ray's block this
    round or -1; ``counts`` (2,) int32, the active count of even and odd
    rounds."""
    node: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    sp: torch.Tensor
    cursor: torch.Tensor
    t_best: torch.Tensor
    prim: torch.Tensor
    found: torch.Tensor
    active: torch.Tensor
    stack_node: torch.Tensor
    stack_tmin: torch.Tensor
    stack_tmax: torch.Tensor
    keys: torch.Tensor
    counts: torch.Tensor

    def clone(self) -> "WalkState":
        return WalkState(**{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)})


def init_state(kd, o, d, t_max, stack_depth: int):
    """The walk's state before its first round, and ``inv_d = 1 / d``: the
    root slab test in torch, as ``traverse._walk`` does it, so that the
    round kernel cannot round it differently."""
    n, dev = o.shape[0], o.device
    inv_d = 1.0 / d
    root_hit, tmin, tmax = slab_test(kd.bounds_min, kd.bounds_max, o, inv_d, t_max)
    active = root_hit & ~(tmin > t_max)  # kdtree.cpp:274
    zi = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    st = WalkState(
        node=zi(), tmin=tmin.to(torch.float32).clone(), tmax=tmax.to(torch.float32).clone(), sp=zi(), cursor=zi(),
        t_best=t_max.to(torch.float32).clone(), prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        found=zi(), active=active.to(torch.int32),
        stack_node=torch.zeros((stack_depth, n), dtype=torch.int32, device=dev),
        stack_tmin=torch.zeros((stack_depth, n), dtype=torch.float32, device=dev),
        stack_tmax=torch.zeros((stack_depth, n), dtype=torch.float32, device=dev),
        keys=torch.full((n,), -1, dtype=torch.int32, device=dev),
        counts=torch.zeros((2,), dtype=torch.int32, device=dev))
    return st, inv_d.contiguous()


def descend_plain(kd, nodes, o, d, inv_d, t_max, st: WalkState, t_leaf, prim_leaf, rnd: int, any_hit: bool):
    """One round of the walk on ``st``, in place: the round kernel's plain
    version, ``traverse._walk``'s operations in the kernel's order.  Round
    ``rnd`` > 0 first folds the last leaf result (``t_leaf``, ``prim_leaf``
    where the ray had a block); then every active ray descends to its next
    leaf; then ``st.keys`` gets each ray's block this round (-1: none) and
    ``st.counts[rnd % 2]`` the number of rays still active
    (``st.counts[1 - rnd % 2]`` is set to 0 for the next round)."""
    n, depth = o.shape[0], st.stack_node.shape[0]
    bl, num_blocks = kd.block_lanes, kd.block_orig.shape[0]
    ints = nodes.view(torch.int32)
    flag_of, split_of, right_of, start_of, lanes_of = ints[:, 0], nodes[:, 1], ints[:, 2], ints[:, 3], ints[:, 4]
    cols = torch.arange(n, device=o.device)
    node, sp, cursor = st.node.long(), st.sp.long(), st.cursor.clone()
    tmin, tmax, t_best = st.tmin.clone(), st.tmax.clone(), st.t_best.clone()
    active = st.active.bool()

    if rnd > 0:  # _walk's leaf phase, after the leaf stage
        clip = torch.minimum(t_best, t_max)
        act = active & ~(clip < tmin)
        leaf_lanes = lanes_of[node]
        improved = act & (cursor < leaf_lanes) & (t_leaf < clip)
        t_best = torch.where(improved, t_leaf, t_best)
        st.prim.copy_(torch.where(improved, prim_leaf, st.prim))
        st.found.copy_(st.found | improved.to(torch.int32))
        cursor = torch.where(act, cursor + bl, cursor)
        leaf_done = act & (cursor >= leaf_lanes)
        if any_hit:
            leaf_done = leaf_done & ~improved
            act = act & ~improved
        can_pop = sp > 0
        pop = leaf_done & can_pop
        e = (sp - 1).clamp(0, depth - 1)
        node = torch.where(pop, st.stack_node[e, cols].long(), node)
        tmin = torch.where(pop, st.stack_tmin[e, cols], tmin)
        tmax = torch.where(pop, st.stack_tmax[e, cols], tmax)
        sp = torch.where(pop, sp - 1, sp)
        cursor = torch.where(pop, 0, cursor)
        active = act & ~(leaf_done & ~can_pop)

    while True:  # descend every active ray to its next leaf
        flag = flag_of[node]
        interior = active & (flag < LEAF_FLAG)
        if not bool(interior.any()):
            break
        clip = torch.minimum(t_best, t_max)
        act = active & ~(clip < tmin)  # kdtree.cpp:286-289
        step = act & interior
        axis = flag.clamp(0, 2).long()[:, None]
        o_ax = torch.gather(o, 1, axis)[:, 0]
        d_ax = torch.gather(d, 1, axis)[:, 0]
        inv_ax = torch.gather(inv_d, 1, axis)[:, 0]
        split = split_of[node]
        right = right_of[node].long()
        t_plane = (split - o_ax) * inv_ax
        left_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0.0))
        near = torch.where(left_first, node + 1, right)
        far = torch.where(left_first, right, node + 1)
        skip_far = (t_plane > tmax) | (t_plane <= 0.0)
        skip_near = ~skip_far & (t_plane < tmin)
        push = step & ~skip_far & ~skip_near
        ip = torch.nonzero(push)[:, 0]
        e = sp[ip].clamp(0, depth - 1)
        st.stack_node[e, ip] = far[ip].to(torch.int32)
        st.stack_tmin[e, ip] = t_plane[ip]
        st.stack_tmax[e, ip] = tmax[ip]
        sp = torch.where(push, sp + 1, sp)
        tmax = torch.where(push, t_plane, tmax)
        node = torch.where(step, torch.where(skip_near, far, near), node)
        active = torch.where(interior, act, active)

    clip = torch.minimum(t_best, t_max)
    work = active & ~(clip < tmin) & (cursor < lanes_of[node])
    key = (start_of[node] // bl + cursor // bl).clamp(0, num_blocks - 1)
    st.keys.copy_(torch.where(work, key, -1))
    for dst, src in ((st.node, node), (st.sp, sp), (st.cursor, cursor), (st.tmin, tmin), (st.tmax, tmax),
                     (st.t_best, t_best), (st.active, active)):
        dst.copy_(src)
    st.counts[rnd % 2] = active.sum()
    st.counts[1 - rnd % 2] = 0


def descend(kd, nodes, o, d, inv_d, t_max, st: WalkState, t_leaf, prim_leaf, rnd: int, any_hit: bool) -> None:
    """One round of the binned walk's descend on ``st``, in place, as
    ``descend_plain`` says: the round kernel for CUDA tensors, that plain
    version for CPU tensors.  ``nodes`` is ``traverse._pack_nodes(kd)``;
    the inputs are those ``binned_traverse`` checks, and ``st`` and
    ``inv_d`` come from ``init_state``."""
    if o.device.type == "cpu":
        descend_plain(kd, nodes, o, d, inv_d, t_max, st, t_leaf, prim_leaf, rnd, any_hit)
        return
    if o.device.type != "cuda":
        raise ValueError(f"descend runs on cuda or cpu tensors, got {o.device}")
    n = o.shape[0]
    if n == 0:
        return
    ptr = lambda x: 0 if x is None else x.data_ptr()
    state = [st.node, st.tmin, st.tmax, st.sp, st.cursor, st.t_best, st.prim, st.found, st.active,
             st.stack_node, st.stack_tmin, st.stack_tmax]
    fold = rnd > 0
    with torch.cuda.device(o.device):
        err = _fn_descend()(nodes.data_ptr(), o.data_ptr(), d.data_ptr(), inv_d.data_ptr(), t_max.data_ptr(),
                            *(x.data_ptr() for x in state), ptr(t_leaf) if fold else 0,
                            ptr(prim_leaf) if fold else 0, st.keys.data_ptr(), st.counts.data_ptr(), n,
                            st.stack_node.shape[0], kd.block_lanes, kd.block_orig.shape[0], int(fold),
                            int(any_hit), rnd % 2, _cuda.stream_of(o.device))
    _cuda.raise_on(err, DESCEND)
    descend_launches["any_hit" if any_hit else "closest"] += 1


def walk_rounds(kd, o, d, t_max, stack_depth: int, any_hit: bool, leaf=None):
    """The walk as rounds over the whole batch -> (t, prim, found): each
    round ``descend``, the leaf stage over every ray, then one read of the
    active count, until it is 0.  ``leaf(kd, o, d, keys) -> (t, prim)`` is
    the leaf stage, as ``traverse._walk`` takes it; by default this
    module's ``_launch`` (looked up at each walk) for CUDA tensors, where
    nothing but the count read syncs the host, and ``leaf_plain`` for CPU
    tensors."""
    mode = "any_hit" if any_hit else "closest"
    if leaf is None:
        leaf = functools.partial(_launch, mode=mode) if o.device.type == "cuda" else leaf_plain
    st, inv_d = init_state(kd, o, d, t_max, stack_depth)
    nodes = _pack_nodes(kd)
    t_leaf = prim_leaf = None
    rnd = 0
    while True:
        descend(kd, nodes, o, d, inv_d, t_max, st, t_leaf, prim_leaf, rnd, any_hit)
        t_leaf, prim_leaf = leaf(kd, o, d, st.keys)
        if int(st.counts[rnd % 2]) == 0:
            break
        rnd += 1
    return st.t_best, st.prim, st.found.bool()


@torch.no_grad()
def binned_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """The binned kd walk -> (t (N,) f32, prim (N,) i32, -1 where no hit,
    found (N,) bool), over the whole batch at once.  It visits the blocks
    the plain walk visits, in the same order, with the same leaf test, so
    it gives ``traverse_plain``'s bits.

    CUDA tensors run ``walk_rounds``: per round the round kernel and the
    block-loop kernel, and one host read.  They need ``block_g``,
    ``block_tris`` and ``block_orig`` (a missing one raises ``ValueError``
    before the walk starts), slots and spad multiples of 4, and
    ``stack_depth`` in [1, 64].  CPU tensors take ``traverse._walk`` with
    ``leaf_plain``.
    """
    t_max = t_max.to(torch.float32)
    if o.device.type == "cpu":
        return _walk(kd, o, d, t_max, stack_depth, any_hit, False, leaf_plain)
    if o.device.type != "cuda":
        raise ValueError(f"binned_traverse runs on cuda or cpu tensors, got {o.device}")
    _check(kd, o, d)
    _cuda.check("t_max", t_max, torch.float32, (o.shape[0],), o.device)
    if not 1 <= stack_depth <= 64:
        raise ValueError(f"stack_depth {stack_depth} outside [1, 64]")
    if kd.block_lanes < 1:
        raise ValueError(f"block_lanes {kd.block_lanes} < 1")
    return walk_rounds(kd, o, d, t_max, stack_depth, any_hit)
