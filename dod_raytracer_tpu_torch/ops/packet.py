"""Wrappers of the CUDA kd-traversal kernels of ``csrc/packet_traverse.cu``.

Counterpart of ``dod_raytracer_tpu.ops.pallas.packet_kernel.packet_traverse``.
The kernels are built at first use with plain ``nvcc`` and bound with
``ctypes`` (``ops._cuda``).

``packet_traverse`` is the frame's kernel: a warp-coherent packet walk (one
warp of 32 consecutive rays shares one node cursor and stack; wanted leaf
blocks are staged in shared memory by ``cp.async``; ``csrc/kd_warp.cuh``,
the template the mega and forest walks share).  It launches for CUDA
tensors and takes the plain walk (``traverse.traverse_plain``) only for
CPU tensors.  Every launch adds one to ``launches[mode]``; nothing else
does.

``packet_traverse_per_ray`` reaches the per-ray walk that the packet walk
replaced (one thread per ray), with its own count ``per_ray_launches``.
It is for measurement only: its ``kStats`` build counts the work behind
the kernel's least-time bound, and ``chip_smoke.py`` times it beside the
packet walk.  The frame never calls it.

Parity (the JAX package's rule for its packet kernel, tests/test_packet.py):
against the per-ray walks every warp walk (packet, mega, forest) gives
equal hit masks and any-hit bits and bit-equal closest-hit t; a prim may
differ only where two triangles' Möller–Trumbore t are bit-equal (the
packet visits the union of its rays' leaves in its own order).  ``parity``
counts it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .traverse import _pack_nodes, traverse_plain
from .triangle import mt_t_edges

NAME = "packet_traverse"
# warps (packets) of a CTA of the packet walk, each with one staged block:
# 8 blocks of 27.6 KB (spad 384) in 221 KB of shared memory, one CTA per SM
# (csrc/packet_traverse.cu says why not 4 warps of two slots)
WARPS = 8
SMEM_LIMIT = 232448  # dynamic shared memory one CTA may use (227 KB)
# per-warp counts of the packet walk's measurement build
STATS = ("node_steps", "blocks_staged", "wanting_lanes", "blocks_unwanted", "distances")
_TABLES = ("block_orig", "block_tris", "block_g", "block_aabb")

# kernel launches by mode, counted where each kernel is launched
launches = {"closest": 0, "any_hit": 0}
per_ray_launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for counts in (launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def _fn():
    return _cuda.library(NAME, "dod_packet_traverse",
                         [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _fn_per_ray():
    return _cuda.library(NAME, "dod_packet_traverse_per_ray",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def smem_bytes(spad: int) -> int:
    """Dynamic shared memory of one CTA of the packet walk: each warp's
    staged block, 18 rows of ``spad`` floats."""
    return WARPS * 18 * spad * 4


def _tables(kd, o, d, t_max, stack_depth, stats=None, touched=None):
    """Checks shared by both kernels (``stats`` and ``touched``: the
    per-ray walk's) -> (node table, world bounds)."""
    _cuda.check_rays(kd, o, d, t_max, stack_depth, stats, touched, _TABLES)
    _cuda.check("block_aabb", kd.block_aabb, torch.float32, (6, kd.block_orig.shape[0]), o.device)
    return _pack_nodes(kd), torch.cat([kd.bounds_min, kd.bounds_max])


def check_warp(kd, o, stack_depth: int, stats) -> None:
    """What the warp walks (``csrc/kd_warp.cuh``: the packet, mega and
    forest kernels) need beyond ``_cuda.check_rays``, for CUDA tensors:
    ``block_aabb`` (6, B); ``stats`` None or (ceil(N / 32), 5) int32; a
    tree whose recorded depth (``kd.max_depth``, set by every build of the
    port) is no more than ``stack_depth``, since the warp's shared stack
    may not drop an entry that some lane still needs; slots a multiple of
    4 and spad of 128 (4-slot loads from 128-slot sections); WARPS staged
    blocks within the shared memory of a CTA; block_g 16-byte aligned.
    Raises ``ValueError`` (``TypeError`` for a dtype) otherwise."""
    dev, n = o.device, o.shape[0]
    B, S = kd.block_orig.shape
    _cuda.check("block_aabb", kd.block_aabb, torch.float32, (6, B), dev)
    if stats is not None:
        _cuda.check("stats", stats, torch.int32, ((n + 31) // 32, len(STATS)), dev)
    if not kd.max_depth or kd.max_depth > stack_depth:
        raise ValueError(f"the warp walks need a stack as deep as the tree: depth {kd.max_depth or 'unknown'}, "
                         f"stack_depth {stack_depth}")
    spad = kd.block_g.shape[2] // 5
    if S % 4 or spad % 128:
        raise ValueError(f"the warp walks read 4 slots at a time from 128-slot sections: slots {S}, spad {spad}")
    if smem_bytes(spad) > SMEM_LIMIT:
        raise ValueError(f"{WARPS} staged blocks take {smem_bytes(spad)} bytes at spad {spad}, "
                         f"over the {SMEM_LIMIT} bytes of shared memory a CTA may use")
    if kd.block_g.data_ptr() % 16:
        raise ValueError("block_g is not 16-byte aligned")


def packet_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None):
    """kd traversal of N rays -> (t (N,) f32, prim (N,) i32, -1 where no
    hit, found (N,) bool), by the packet walk.

    CUDA tensors need the kd tables ``block_orig``, ``block_tris``,
    ``block_g`` and ``block_aabb``, and what ``check_warp`` lists (a tree
    no deeper than ``stack_depth`` among them); otherwise ``ValueError``.
    CPU tensors take the plain walk, which, like the JAX kernels, drops its
    deepest entry instead; the render path's ``ops.traverse._stack_depth``
    always covers the tree unless ``cfg.stack_depth`` is set below its
    depth.

    ``stats`` is for measurement only (the frame never passes it): an
    optional (ceil(N / 32), 5) int32 CUDA tensor into which a separate
    build of the kernel writes each warp's counts ``STATS``.
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"packet_traverse runs on cuda or cpu tensors, got {o.device}")
    dev = o.device
    n = o.shape[0]
    nodes, bounds = _tables(kd, o, d, t_max, stack_depth)
    check_warp(kd, o, stack_depth, stats)
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    t_out, prim, found = _cuda.outputs(n, dev)
    if n == 0:
        return t_out, prim, found.bool()
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(nodes.data_ptr(), bounds.data_ptr(), kd.block_aabb.data_ptr(), kd.block_g.data_ptr(),
                 kd.block_tris.data_ptr(), kd.block_orig.data_ptr(), o.data_ptr(), d.data_ptr(),
                 t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(), found.data_ptr(),
                 0 if stats is None else stats.data_ptr(), n, B, S, spad, kd.block_lanes, stack_depth,
                 int(any_hit), _cuda.stream_of(dev))
    _cuda.raise_on(err, "packet_traverse")
    launches["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()


def packet_traverse_per_ray(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """The same traversal by the per-ray walk (one thread per ray), for
    measurement only: the same outputs as ``traverse_plain`` bit for bit.

    ``stats``: an optional (N, 4) int32 CUDA tensor into which a separate
    build writes each ray's interior-node steps, tested (AABB-passing)
    blocks, non-empty slots of those blocks whose edge signs it tested and
    slots whose distance it computed.  ``touched``: an optional (B, 2 + S)
    int32 CUDA tensor, zeroed by the caller, in which that build marks the
    blocks whose AABB it read (column 0), the blocks it edge-tested (column
    1) and the slots whose triangle row it read (column 2 + j).
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"packet_traverse_per_ray runs on cuda or cpu tensors, got {o.device}")
    dev = o.device
    n = o.shape[0]
    nodes, bounds = _tables(kd, o, d, t_max, stack_depth, stats, touched)
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    t_out, prim, found = _cuda.outputs(n, dev)
    if n == 0:
        return t_out, prim, found.bool()
    fn = _fn_per_ray()
    with torch.cuda.device(dev):
        err = fn(nodes.data_ptr(), bounds.data_ptr(), kd.block_aabb.data_ptr(),
                 kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 found.data_ptr(), 0 if stats is None else stats.data_ptr(),
                 0 if touched is None else touched.data_ptr(), n, B, S, spad, kd.block_lanes, stack_depth,
                 int(any_hit), _cuda.stream_of(dev))
    _cuda.raise_on(err, "packet_traverse_per_ray")
    per_ray_launches["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()


def prim_t(kd, prim, o, d):
    """(N,) the Möller–Trumbore t that the kernels' leaf test computes for
    triangle ``prim[i]`` on ray i, from its ``block_tris`` row
    (``ops/triangle.py`` ``mt_t_edges``; inf where t <= 0): the parity
    rule's test of a tie between two prims."""
    valid = kd.block_orig >= 0
    rows = torch.zeros((int(kd.block_orig.max()) + 1, 9), dtype=kd.block_tris.dtype, device=o.device)
    rows[kd.block_orig[valid].long()] = kd.block_tris[valid]
    r = rows[prim.long()][:, None, :]
    inside = torch.ones((o.shape[0], 1), dtype=torch.bool, device=o.device)
    return mt_t_edges(r[..., 0:3], r[..., 3:6], r[..., 6:9], o, d, inside)[:, 0]


def parity(kd, out, ref, o, d, any_hit: bool) -> dict:
    """The packet walk's outputs ``out`` against a per-ray walk's ``ref``
    (t, prim, found) under the parity rule -> counts.  ``mask_mismatch``:
    found bits that differ; closest-hit only: ``t_not_exact`` (t not
    bit-equal), ``prim_ties`` (prims that differ where both triangles' t
    are bit-equal) and ``prim_not_tie`` (other prim differences).  The
    rule holds when every count but ``prim_ties`` is 0."""
    tk, pk, fk = out
    tr, pr, fr = ref
    res = dict(rays=int(o.shape[0]), mask_mismatch=int((fk != fr).sum()))
    if any_hit:
        return res
    flip = fk & fr & (pk != pr)
    tie = torch.zeros_like(flip)
    if bool(flip.any()):
        tie[flip] = prim_t(kd, pk[flip], o[flip], d[flip]) == prim_t(kd, pr[flip], o[flip], d[flip])
    res.update(t_not_exact=int((tk != tr).sum()), prim_ties=int(tie.sum()), prim_not_tie=int((flip & ~tie).sum()))
    return res


def parity_holds(res: dict) -> bool:
    return all(v == 0 for k, v in res.items() if k not in ("rays", "prim_ties"))
