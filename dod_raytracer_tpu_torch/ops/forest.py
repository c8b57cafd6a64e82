"""Wrappers of the CUDA kd walks of ``csrc/kd_walk.cu`` over the forest layout.

Counterpart of ``dod_raytracer_tpu.ops.pallas.forest_kernel.forest_traverse``:
the two-level walk over the top table and the treelet tables
(``accel._kdtree_np.cut_treelets``) of a tree of more than ``treelet_cap``
nodes.

``forest_traverse`` is the ``"forest"`` backend's kernel: the warp walk of
``csrc/kd_warp.cuh`` (as ``ops.mega.mega_traverse``) over the (Ttop, 4) top
rows and (T, cap, 6) treelet rows; the warp's table travels with every
stack entry.  It launches for CUDA tensors and takes the plain forest walk
(``traverse.traverse_forest_plain``) only for CPU tensors.  Every launch
adds one to ``launches[mode]``; nothing else does.  It is held to the
packet walk's parity rule (``ops.packet.parity``) against the plain walks
and against the packet walk on the same tree.

``forest_traverse_per_ray`` reaches the per-ray walk that the warp walk
replaced, with its own count ``per_ray_launches``: the plain walk's bits,
for measurement only.
"""

from __future__ import annotations

import torch

from . import _cuda
from .mega import check, launch_walk
from .traverse import traverse_forest_plain

_TABLES = ("tre_tbl", "top_tbl")

# kernel launches by mode, counted where each kernel is launched
launches = {"closest": 0, "any_hit": 0}
per_ray_launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for counts in (launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def _check(kd, o, d, t_max, stack_depth, per_ray, stats, touched):
    check(kd, o, d, t_max, stack_depth, per_ray, stats, touched, _TABLES)
    _cuda.check("top_tbl", kd.top_tbl, torch.float32, (kd.top_tbl.shape[0], 4), o.device)
    _cuda.check("tre_tbl", kd.tre_tbl, torch.float32, (*kd.tre_tbl.shape[:2], 6), o.device)


def forest_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None):
    """Two-level kd walk -> (t (N,) f32, prim (N,) i32, -1 where no hit,
    found (N,) bool), by the warp walk.

    CUDA tensors need ``tre_tbl``, ``top_tbl``, ``block_orig``,
    ``block_tris``, ``block_g`` and ``block_aabb``, and what
    ``ops.packet.check_warp`` lists; otherwise ``ValueError``.  ``stats``
    is as for ``ops.mega.mega_traverse``.
    """
    if o.device.type == "cpu":
        return traverse_forest_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"forest_traverse runs on cuda or cpu tensors, got {o.device}")
    _check(kd, o, d, t_max, stack_depth, False, stats, None)
    return launch_walk(kd, kd.top_tbl, kd.tre_tbl, o, d, t_max, stack_depth, any_hit, stats, None,
                       launches, False)


def forest_traverse_per_ray(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """The same walk by the per-ray kernel, for measurement only: the
    outputs of ``traverse_forest_plain`` (and ``traverse_plain``) bit for
    bit.  ``stats`` and ``touched`` are as for
    ``ops.mega.mega_traverse_per_ray``."""
    if o.device.type == "cpu":
        return traverse_forest_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"forest_traverse_per_ray runs on cuda or cpu tensors, got {o.device}")
    _check(kd, o, d, t_max, stack_depth, True, stats, touched)
    return launch_walk(kd, kd.top_tbl, kd.tre_tbl, o, d, t_max, stack_depth, any_hit, stats, touched,
                       per_ray_launches, True)
