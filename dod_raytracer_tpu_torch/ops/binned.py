"""The binned kd walk and its CUDA leaf stage (``csrc/block_loop.cu``).

Counterpart of ``dod_raytracer_tpu.ops.pallas.block_loop_kernel``
(``block_loop_intersect``) and of the JAX package's binned traversal
(``traverse.py`` ``_traverse_binned``), which ``_backend`` picks for
``"binned"``, and for ``"mega"`` on a tree of more than ``MAX_NODES``
nodes.  The walk's descend phase is torch (``traverse._walk``); its leaf
stage is one kernel launch per round on the rays that have work, as the
JAX package runs one kernel per round of its ``while_loop``.

``block_loop_intersect`` launches the kernel for CUDA tensors and takes
its plain version (``traverse.leaf_plain``, the same leaf test) only for
CPU tensors.  Every kernel launch adds one to ``launches[mode]``; nothing
else does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .traverse import _walk, leaf_plain

NAME = "block_loop"

# kernel launches by mode of the walk that made them, counted where the
# kernel is launched
launches = {"closest": 0, "any_hit": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn():
    return _cuda.library(NAME, "dod_block_loop", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(kd, o, d):
    """The tables and rays a launch reads, for CUDA tensors."""
    n = o.shape[0]
    dev = o.device
    _cuda.check_count(n)
    _cuda.check_blocks(kd, ("block_orig", "block_tris", "block_g"), dev)
    _cuda.check("o", o, torch.float32, (n, 3), dev)
    _cuda.check("d", d, torch.float32, (n, 3), dev)


def _launch(kd, o, d, keys, mode: str, stats=None, touched=None):
    """One launch on checked inputs -> (t, prim)."""
    n = o.shape[0]
    dev = o.device
    B, S = kd.block_orig.shape
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, prim
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(),
                 keys.data_ptr(), o.data_ptr(), d.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 0 if stats is None else stats.data_ptr(), 0 if touched is None else touched.data_ptr(),
                 n, B, S, kd.block_g.shape[2] // 5, _cuda.stream_of(dev))
    _cuda.raise_on(err, NAME)
    launches[mode] += 1
    return t_out, prim


def block_loop_intersect(kd, o, d, keys, mode: str = "closest", stats=None, touched=None):
    """The closest hit of each ray in block ``keys[i]`` -> (t (N,) f32,
    prim (N,) i32); (inf, 2**30) where the block holds no hit or the key is
    outside [0, B).

    ``mode`` ("closest" or "any_hit", the walk's mode) only names the count
    the launch adds to.  CUDA tensors need ``block_g``, ``block_tris`` and
    ``block_orig``, and int32 keys.  ``stats`` and ``touched`` are for
    measurement only: an optional (N, 2) int32 CUDA tensor into which a
    separate build writes each ray's non-empty slots edge-tested and
    distances computed, and an optional (B, 2 + S) int32 one, zeroed by the
    caller, in which it marks the blocks edge-tested (column 1) and the
    slots whose triangle row it read (column 2 + j).
    """
    if o.device.type == "cpu":
        return leaf_plain(kd, o, d, keys)
    if o.device.type != "cuda":
        raise ValueError(f"block_loop_intersect runs on cuda or cpu tensors, got {o.device}")
    if mode not in launches:
        raise ValueError(f"mode {mode!r} is not one of {list(launches)}")
    _check(kd, o, d)
    n = o.shape[0]
    _cuda.check("keys", keys, torch.int32, (n,), o.device)
    _cuda.check_marks(kd, stats, touched, n, 2, o.device)
    return _launch(kd, o, d, keys, mode, stats, touched)


@torch.no_grad()
def binned_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool):
    """The binned kd walk -> (t (N,) f32, prim (N,) i32, -1 where no hit,
    found (N,) bool): the plain walk's descend with ``block_loop_intersect``
    as its leaf stage, over the whole batch at once.  It visits the blocks
    the plain walk visits, in the same order, with the same leaf test, so it
    gives ``traverse_plain``'s bits.

    CUDA tensors need ``block_g``, ``block_tris`` and ``block_orig``; a
    missing one raises ``ValueError`` before the walk starts.  The tables
    and rays are checked once here; each round launches on the walk's own
    int32 keys and ray subsets without checking them again.
    """
    mode = "any_hit" if any_hit else "closest"
    if o.device.type == "cpu":
        leaf = leaf_plain
    elif o.device.type == "cuda":
        _check(kd, o, d)

        def leaf(kd, o, d, keys):
            return _launch(kd, o, d, keys, mode)
    else:
        raise ValueError(f"binned_traverse runs on cuda or cpu tensors, got {o.device}")
    return _walk(kd, o, d, t_max.to(torch.float32), stack_depth, any_hit, False, leaf)
