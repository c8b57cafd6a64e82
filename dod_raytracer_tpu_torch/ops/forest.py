"""Wrapper of the CUDA forest kd walk (``csrc/kd_walk.cu``, kForest = true).

Counterpart of ``dod_raytracer_tpu.ops.pallas.forest_kernel.forest_traverse``:
the two-level walk over the top table and the treelet tables
(``accel._kdtree_np.cut_treelets``) of a tree of more than ``treelet_cap``
nodes.  ``forest_traverse`` launches the kernel for CUDA tensors and takes
the plain forest walk (``traverse.traverse_forest_plain``) only for CPU
tensors.  Every kernel launch adds one to ``launches[mode]``; nothing
else does.
"""

from __future__ import annotations

import torch

from . import _cuda
from .mega import launch_walk
from .traverse import traverse_forest_plain

# kernel launches by mode, counted where the kernel is launched
launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def forest_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None, touched=None):
    """Two-level kd walk -> (t (N,) f32, prim (N,) i32, -1 where no hit,
    found (N,) bool), the same bits as the one-table walk.

    CUDA tensors need ``tre_tbl``, ``top_tbl``, ``block_orig``,
    ``block_tris`` and ``block_g``; a missing one raises ``ValueError``.
    ``stats`` and ``touched`` are as for ``ops.mega.mega_traverse``.
    """
    if o.device.type == "cpu":
        return traverse_forest_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"forest_traverse runs on cuda or cpu tensors, got {o.device}")
    _cuda.check_rays(kd, o, d, t_max, stack_depth, stats, touched,
                     ("tre_tbl", "top_tbl", "block_orig", "block_tris", "block_g"))
    _cuda.check("top_tbl", kd.top_tbl, torch.float32, (kd.top_tbl.shape[0], 4), o.device)
    _cuda.check("tre_tbl", kd.tre_tbl, torch.float32, (*kd.tre_tbl.shape[:2], 6), o.device)
    return launch_walk(kd, kd.top_tbl, kd.tre_tbl, o, d, t_max, stack_depth, any_hit, stats,
                       touched, launches)
