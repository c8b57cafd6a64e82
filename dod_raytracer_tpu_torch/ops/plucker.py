"""Brute-force closest hit in Plücker form: the CUDA kernel
``csrc/plucker_closest.cu``, its plain version and its input layouts.

Counterpart of ``dod_raytracer_tpu.ops.pallas.plucker_kernel``
(``plucker_pack``, ``swizzle_rays_plucker``, ``plucker_closest``), which
the JAX package runs for ``triangle_backend="plucker"`` on the brute-force
branch of ``intersect._triangles_closest``.  Per ray-triangle pair, the
ray row r = [d, o x d, o, 1] against the triangle's packed columns gives
the three edge sides s0, s1, s2, den = n.d and num = n.A - n.o; a hit has
three sides of one strict sign, den != 0 and t = num / den > 0.  This t is
the TPU kernel's, with the packed n.A, not Möller–Trumbore's.

Each of the five dot products is summed in row order, every product and
sum rounded on its own, and only over the rows that are not zero by
construction (s0..s2: rows 0-5, den: rows 0-2, num: rows 6-9); a zero row
adds only a signed zero, which no test reads.  The kernel and
``plucker_closest_plain`` compute exactly that, so they give the same
bits; ``torch.matmul`` would leave the order to the card.

``plucker_closest`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  On the card a call splits the
triangle axis over CTAs when the rays alone would not fill the card and
merges the splits exactly (``ops/brute.py``), with exact early exits in
the pair test; it adds one to ``launches["closest"]`` however many
launches it makes; nothing else does.  ``plucker_closest_per_ray`` (the
one thread per ray kernel it replaced) is for measurement only, with its
own count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, brute
from .ray import INF
from .triangle import _cross, _dot, first_min, plucker_row

NAME = "plucker_closest"
TILE_T = 512  # triangle padding of plucker_pack (the JAX package's tile)
# the feature rows of each of the five sections [s0|s1|s2|den|num] that are
# not zero by construction
ROWS = (range(0, 6), range(0, 6), range(0, 6), range(0, 3), range(6, 10))
# the stats build's columns: the stage a pair stopped at (the signs of s0
# and s1, of s2, of num against den's) or "div", the whole test
EXITS = ("s0s1", "s2", "num_den", "div")

launches = {"closest": 0}
per_ray_launches = {"closest": 0}


def reset_launches() -> None:
    for counts in (launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def plucker_pack(verts: torch.Tensor, tile_t: int = TILE_T) -> torch.Tensor:
    """(T, 3, 3) -> (5, 10, T') packed per-triangle columns [s0|s1|s2|den|num]
    over the ray row [d, o x d, o, 1], T' the next multiple of ``tile_t``;
    zero padding columns are rejected (every side and den is 0).  Each
    cross and dot product is spelled out one operation at a time, so the
    columns are the same bits on the CPU and on the card."""
    pad = (-verts.shape[0]) % tile_t
    verts = torch.nn.functional.pad(verts, (0, 0, 0, 0, 0, pad))
    A, B, C = verts[:, 0, :], verts[:, 1, :], verts[:, 2, :]

    def cross(a, b):
        return torch.stack(_cross(a.unbind(-1), b.unbind(-1)), dim=-1)

    n = cross(B - A, C - A)
    z3 = torch.zeros_like(A)
    z1 = torch.zeros_like(A[:, :1])
    cols = [torch.cat(c, dim=1) for c in (
        (cross(A, B), B - A, z3, z1), (cross(B, C), C - B, z3, z1), (cross(C, A), A - C, z3, z1),
        (n, z3, z3, z1), (z3, z3, -n, _dot(n.unbind(-1), A.unbind(-1))[:, None]))]
    return torch.stack(cols).transpose(1, 2).contiguous()  # (5, 10, T')


def swizzle_rays_plucker(o: torch.Tensor, d: torch.Tensor, tile_r: int = 256):
    """(N, 3) x 2 -> ((N', 16) rows [d, o x d, o, 1, 0 x 6] padded with zero
    rows to a multiple of ``tile_r``, N); a zero row never hits.  The JAX
    kernel's ray layout, and the plain version's ray rows; the CUDA kernel
    reads o and d and builds the same row in registers."""
    n = o.shape[0]
    r = torch.cat([plucker_row(o, d), o, torch.ones((n, 1), dtype=o.dtype, device=o.device),
                   torch.zeros((n, 6), dtype=o.dtype, device=o.device)], dim=1)
    return torch.nn.functional.pad(r, (0, 0, 0, (-n) % tile_r)).contiguous(), n


def plucker_closest_plain(g: torch.Tensor, o: torch.Tensor, d: torch.Tensor, chunk: int = 2048):
    """The kernel's plain version: the same row-order sums in torch, over
    triangle chunks, with the running minimum keeping the lowest index."""
    r = swizzle_rays_plucker(o, d, 1)[0]
    n = o.shape[0]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    idx_best = torch.zeros((n,), dtype=torch.int32, device=o.device)
    for base in range(0, g.shape[2], chunk):
        gc = g[:, :, base:base + chunk]
        sums = []
        for sec, rows in enumerate(ROWS):
            s = r[:, rows[0], None] * gc[sec, rows[0]][None]
            for f in rows[1:]:
                s = s + r[:, f, None] * gc[sec, f][None]
            sums.append(s)
        s0, s1, s2, den, num = sums
        pos = (s0 > 0.0) & (s1 > 0.0) & (s2 > 0.0)
        neg = (s0 < 0.0) & (s1 < 0.0) & (s2 < 0.0)
        valid = (pos | neg) & (den != 0.0)
        t = torch.where(valid, num, 0.0) / torch.where(valid, den, 1.0)
        t_c, a = first_min(torch.where(valid & (t > 0.0), t, INF))
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        idx_best = torch.where(better, (a + base).to(torch.int32), idx_best)
    return t_best, idx_best


def _fn():
    return _cuda.library(NAME, "dod_plucker_closest", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _fn_per_ray():
    return _cuda.library(NAME, "dod_plucker_closest_per_ray",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(g, o, d) -> None:
    t_total = g.shape[-1]
    if g.dim() != 3 or t_total % TILE_T:
        raise ValueError(f"g has shape {tuple(g.shape)}: expected (5, 10, a multiple of {TILE_T})")
    brute.check("g", g, (5, 10, t_total), o, d)


@torch.no_grad()
def plucker_closest(g: torch.Tensor, o: torch.Tensor, d: torch.Tensor, splits=None, stats=None):
    """Closest hit of every ray over all triangles -> (t (N,) f32, idx (N,)
    i32); a miss gives (inf, 0), and the lowest index wins a tie.

    ``g`` comes from ``plucker_pack``: (5, 10, T'), T' a multiple of
    ``TILE_T``.  t and idx are ``plucker_closest_plain``'s bits, whatever
    the split count.  For measurement on the card: ``splits`` overrides
    ``brute.splits``' choice, and ``stats``, a zeroed (2, 4) int64 CUDA
    tensor, takes the stats build's counts (rows ``brute.STATS_ROWS``,
    columns ``EXITS``).
    """
    if o.device.type == "cpu":
        return plucker_closest_plain(g, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"plucker_closest runs on cuda or cpu tensors, got {o.device}")
    _check(g, o, d)
    out = brute.launch(_fn(), NAME, g, o, d, splits, stats)
    if o.shape[0]:
        launches["closest"] += 1
    return out


@torch.no_grad()
def plucker_closest_per_ray(g: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The same function by the kernel ``plucker_closest`` replaced (one
    thread per ray over all T' triangles), for measurement only."""
    if o.device.type == "cpu":
        return plucker_closest_plain(g, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"plucker_closest_per_ray runs on cuda or cpu tensors, got {o.device}")
    _check(g, o, d)
    out = brute.launch_per_ray(_fn_per_ray(), "plucker_closest_per_ray", g, o, d)
    if o.shape[0]:
        per_ray_launches["closest"] += 1
    return out
