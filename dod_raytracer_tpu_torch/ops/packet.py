"""Wrapper of the CUDA kd-traversal kernel (``csrc/packet_traverse.cu``).

Counterpart of ``dod_raytracer_tpu.ops.pallas.packet_kernel.packet_traverse``.
The kernel is built at first use with plain ``nvcc`` and bound with
``ctypes`` (``ops._cuda``).

``packet_traverse`` launches the kernel for CUDA tensors and takes the
plain walk (``traverse.traverse_plain``) only for CPU tensors.  Every
kernel launch adds one to ``launches[mode]``; nothing else does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .traverse import _pack_nodes, traverse_plain

NAME = "packet_traverse"

# kernel launches by mode, counted where the kernel is launched
launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn():
    return _cuda.library(NAME, "dod_packet_traverse",
                         [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def packet_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """kd traversal of N rays -> (t (N,) f32, prim (N,) i32, -1 where no
    hit, found (N,) bool).

    CUDA tensors need the kd tables ``block_orig``, ``block_tris``,
    ``block_g`` and ``block_aabb``; a missing one raises ``ValueError``.

    ``stats`` and ``touched`` are for measurement only (the frame never
    passes them): an optional (N, 4) int32 CUDA tensor into which a
    separate build of the kernel writes each ray's interior-node steps,
    tested (AABB-passing) blocks, non-empty slots of those blocks whose
    edge signs it tested and slots whose distance it computed; and an
    optional (B, 2 + S) int32 CUDA tensor, zeroed by the caller, in which
    that build marks the blocks whose AABB it read (column 0), the blocks
    it edge-tested (column 1) and the slots whose triangle row it read
    (column 2 + j).
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"packet_traverse runs on cuda or cpu tensors, got {o.device}")
    _cuda.check_rays(kd, o, d, t_max, stack_depth, stats, touched,
                     ("block_orig", "block_tris", "block_g", "block_aabb"))
    dev = o.device
    n = o.shape[0]
    nodes = _pack_nodes(kd)
    bounds = torch.cat([kd.bounds_min, kd.bounds_max])
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    _cuda.check("block_aabb", kd.block_aabb, torch.float32, (6, B), dev)
    t_out, prim, found = _cuda.outputs(n, dev)
    if n == 0:
        return t_out, prim, found.bool()
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(nodes.data_ptr(), bounds.data_ptr(), kd.block_aabb.data_ptr(),
                 kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 found.data_ptr(), 0 if stats is None else stats.data_ptr(),
                 0 if touched is None else touched.data_ptr(), n, B, S, spad, kd.block_lanes, stack_depth, int(any_hit), _cuda.stream_of(dev))
    _cuda.raise_on(err, "packet_traverse")
    launches["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()

