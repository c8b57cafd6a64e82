"""Wrappers of the CUDA kd walks of ``csrc/kd_walk.cu`` over the mega layout.

Counterpart of ``dod_raytracer_tpu.ops.pallas.traverse_kernel``
(``mega_traverse``, ``pack_nodes_mega``).

``mega_traverse`` is the ``"mega"`` backend's kernel: the warp-coherent
packet walk of ``csrc/kd_warp.cuh`` (one warp of 32 consecutive rays
shares one node cursor and stack; a per-block AABB pre-test and a ballot
pick the leaf blocks, which are staged in shared memory by ``cp.async``)
over the (M, 6) rows of ``pack_nodes_mega``.  It launches for CUDA tensors
and takes the plain walk (``traverse.traverse_plain``) only for CPU
tensors.  Every launch adds one to ``launches[mode]``; nothing else does.
It is held to the packet walk's parity rule (``ops.packet.parity``): hit
masks and any-hit bits equal the plain walk's, closest-hit t bit-equal, a
prim may differ only at a bit-equal Möller–Trumbore tie.

``mega_traverse_per_ray`` reaches the per-ray walk that the warp walk
replaced (one thread per ray, no AABB pre-test), with its own count
``per_ray_launches``: the plain walk's bits, for measurement only.

``launch_walk`` is the launch shared with ``ops.forest``: both layouts are
one kernel source.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .packet import check_warp
from .traverse import traverse_plain

NAME = "kd_walk"
_TABLES = ("block_orig", "block_tris", "block_g")

# kernel launches by mode, counted where each kernel is launched
launches = {"closest": 0, "any_hit": 0}
per_ray_launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for counts in (launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def pack_nodes_mega(kd) -> torch.Tensor:
    """(M, 6) f32 node table [flag|split|right|leaf_start|leaf_lanes|block0]
    with the int columns bit-cast; block0 = leaf_start // block_lanes.  The
    JAX package's ``pack_nodes_mega`` holds the same values as floats in
    (Mpad, 128) rows for its TPU matmul fetch."""
    bc = lambda a: a.to(torch.int32).contiguous().view(torch.float32)
    block0 = kd.node_leaf_start // max(kd.block_lanes, 1)
    return torch.stack([
        bc(kd.node_flag), kd.node_split, bc(kd.node_right),
        bc(kd.node_leaf_start), bc(kd.node_leaf_lanes), bc(block0)], dim=1).contiguous()


def _fn():
    return _cuda.library(NAME, "dod_kd_warp_walk",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _fn_per_ray():
    return _cuda.library(NAME, "dod_kd_walk",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def check(kd, o, d, t_max, stack_depth: int, per_ray: bool, stats, touched, tables=()) -> None:
    """The checks of a mega or forest walk for CUDA tensors: the rays and
    the leaf tables (``_cuda.check_rays``, with ``tables`` besides); the
    warp walk's own needs (``ops.packet.check_warp``: ``block_aabb``, its
    (ceil(N / 32), 5) ``stats``, the stack and shared memory), or the
    per-ray walk's (N, 4) ``stats`` and ``touched``."""
    if per_ray:
        _cuda.check_rays(kd, o, d, t_max, stack_depth, stats, touched, _TABLES + tuple(tables))
        return
    if touched is not None:
        raise ValueError("touched is written only by the per-ray walks' stats build")
    _cuda.check_rays(kd, o, d, t_max, stack_depth, None, None, _TABLES + ("block_aabb",) + tuple(tables))
    check_warp(kd, o, stack_depth, stats)


def launch_walk(kd, nodes, tre, o, d, t_max, stack_depth: int, any_hit: bool, stats, touched, counts,
                per_ray: bool):
    """Launch a kd walk on checked CUDA tensors: mega when ``tre`` is None
    (nodes: (M, 6) rows), forest otherwise (nodes: (Ttop, 4) top rows,
    tre: (T, cap, 6) treelet rows); the warp walk, or the per-ray walk
    when ``per_ray`` -> (t, prim, found) as the wrappers return.  Adds
    one to ``counts[mode]`` for the launch."""
    dev = o.device
    n = o.shape[0]
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    num_tre, cap = (0, 0) if tre is None else tre.shape[:2]
    bounds = torch.cat([kd.bounds_min, kd.bounds_max])
    t_out, prim, found = _cuda.outputs(n, dev)
    if n == 0:
        return t_out, prim, found.bool()
    ptr = lambda x: 0 if x is None else x.data_ptr()
    tables = [ptr(nodes), ptr(tre), bounds.data_ptr()] + ([] if per_ray else [kd.block_aabb.data_ptr()])
    tables += [kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr()]
    outs = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
            found.data_ptr(), ptr(stats)] + ([ptr(touched)] if per_ray else [])
    fn = _fn_per_ray() if per_ray else _fn()
    with torch.cuda.device(dev):
        err = fn(*tables, *outs, n, B, S, spad, kd.block_lanes, stack_depth, num_tre, cap,
                 int(tre is not None), int(any_hit), _cuda.stream_of(dev))
    _cuda.raise_on(err, "kd_walk per-ray" if per_ray else "kd_walk warp")
    counts["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()


def mega_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None):
    """kd walk over one node table -> (t (N,) f32, prim (N,) i32, -1 where
    no hit, found (N,) bool), by the warp walk.

    CUDA tensors need the kd tables ``block_orig``, ``block_tris``,
    ``block_g`` and ``block_aabb``, and what ``ops.packet.check_warp``
    lists (a tree no deeper than ``stack_depth`` among them); otherwise
    ``ValueError``.  ``stats`` is for measurement only: an optional
    (ceil(N / 32), 5) int32 CUDA tensor of each warp's counts
    ``ops.packet.STATS``.
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"mega_traverse runs on cuda or cpu tensors, got {o.device}")
    check(kd, o, d, t_max, stack_depth, False, stats, None)
    return launch_walk(kd, pack_nodes_mega(kd), None, o, d, t_max, stack_depth, any_hit, stats, None,
                       launches, False)


def mega_traverse_per_ray(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """The same walk by the per-ray kernel (one thread per ray), for
    measurement only: the outputs of ``traverse_plain`` bit for bit.

    ``stats`` and ``touched`` are as for
    ``ops.packet.packet_traverse_per_ray``, but this walk reads no block
    AABB, so ``touched[:, 0]`` stays 0.
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"mega_traverse_per_ray runs on cuda or cpu tensors, got {o.device}")
    check(kd, o, d, t_max, stack_depth, True, stats, touched)
    return launch_walk(kd, pack_nodes_mega(kd), None, o, d, t_max, stack_depth, any_hit, stats, touched,
                       per_ray_launches, True)
