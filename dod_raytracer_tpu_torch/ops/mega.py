"""Wrapper of the CUDA mega kd walk (``csrc/kd_walk.cu``, kForest = false).

Counterpart of ``dod_raytracer_tpu.ops.pallas.traverse_kernel``
(``mega_traverse``, ``pack_nodes_mega``).  ``mega_traverse``
launches the kernel for CUDA tensors and takes the plain walk
(``traverse.traverse_plain``, the same per-ray walk) only for CPU tensors.
Every kernel launch adds one to ``launches[mode]``; nothing else does.

``launch_walk`` is the launch shared with ``ops.forest``: both walks are
one kernel source with two table layouts.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .traverse import traverse_plain

NAME = "kd_walk"

# kernel launches by mode, counted where the kernel is launched
launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    return _cuda.library(NAME, "dod_kd_walk",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def launch_walk(kd, nodes, tre, o, d, t_max, stack_depth: int, any_hit: bool, stats, touched, counts):
    """Launch the kd walk on CUDA tensors: mega when ``tre`` is None (nodes:
    (M, 6) rows), forest otherwise (nodes: (Ttop, 4) top rows, tre:
    (T, cap, 6) treelet rows) -> (t, prim, found) as the wrappers return.
    Adds one to ``counts[mode]`` for the launch."""
    dev = o.device
    n = o.shape[0]
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    num_tre, cap = (0, 0) if tre is None else tre.shape[:2]
    bounds = torch.cat([kd.bounds_min, kd.bounds_max])
    t_out, prim, found = _cuda.outputs(n, dev)
    if n == 0:
        return t_out, prim, found.bool()
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(nodes.data_ptr(), 0 if tre is None else tre.data_ptr(), bounds.data_ptr(),
                 kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(),
                 o.data_ptr(), d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 found.data_ptr(), 0 if stats is None else stats.data_ptr(),
                 0 if touched is None else touched.data_ptr(), n, B, S, spad, kd.block_lanes, stack_depth, num_tre, cap,
                 int(tre is not None), int(any_hit), _cuda.stream_of(dev))
    _cuda.raise_on(err, "kd_walk")
    counts["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()


def mega_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """Per-ray kd walk over one node table -> (t (N,) f32, prim (N,) i32,
    -1 where no hit, found (N,) bool).

    CUDA tensors need the kd tables ``block_orig``, ``block_tris`` and
    ``block_g``; a missing one raises ``ValueError``.  ``stats`` and
    ``touched`` are for measurement only, as for
    ``ops.packet.packet_traverse`` (this walk reads no block AABB, so
    ``touched[:, 0]`` stays 0).
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"mega_traverse runs on cuda or cpu tensors, got {o.device}")
    _cuda.check_rays(kd, o, d, t_max, stack_depth, stats, touched,
                     ("block_orig", "block_tris", "block_g"))
    return launch_walk(kd, pack_nodes_mega(kd), None, o, d, t_max, stack_depth, any_hit, stats,
                       touched, launches)
