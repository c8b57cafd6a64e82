"""Brute-force Möller–Trumbore closest hit: the CUDA kernel
``csrc/mt_closest.cu`` and its input layouts.

Counterpart of ``dod_raytracer_tpu.ops.pallas.mt_kernel`` (``swizzle_tris``,
``swizzle_rays``, ``mt_closest_pallas``), which the JAX package runs for
``triangle_backend="pallas"`` on the brute-force branch of
``intersect._triangles_closest``.  ``mt_closest`` launches the kernel for
CUDA tensors and takes its plain version (``triangle.closest_edges``, the
torch brute force ``brute_force_closest`` runs, on the same edges) only for
CPU tensors.  On the card a call splits the triangle axis over CTAs when
the rays alone would not fill the card and merges the splits exactly
(``ops/brute.py``), with exact early exits in the pair test; it adds one
to ``launches["closest"]`` however many launches it makes; nothing else
does.  ``mt_closest_per_ray`` (the one thread per ray kernel it replaced)
is for measurement only, with its own count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, brute
from .triangle import closest_edges

NAME = "mt_closest"
TILE_T = 512  # swizzle_tris pads to it (the JAX kernel's tile); the per-ray kernel stages it

# the stats build's columns: the stage a pair stopped at (the sign of the u,
# v or t numerator against det's) or "rcp", the whole test
EXITS = ("u", "v", "t", "rcp")

launches = {"closest": 0}
per_ray_launches = {"closest": 0}


def reset_launches() -> None:
    for counts in (launches, per_ray_launches):
        for k in counts:
            counts[k] = 0


def swizzle_tris(verts: torch.Tensor, tile_t: int = TILE_T) -> torch.Tensor:
    """(T, 3, 3) -> (9, T') SoA rows [A, B - A, C - A], T' the next multiple
    of ``tile_t``; the zero padding triangles never hit (det = 0)."""
    pad = (-verts.shape[0]) % tile_t
    verts = torch.nn.functional.pad(verts, (0, 0, 0, 0, 0, pad))
    A = verts[:, 0, :]
    return torch.cat([A, verts[:, 1, :] - A, verts[:, 2, :] - A], dim=1).T.contiguous()


def swizzle_rays(o: torch.Tensor, d: torch.Tensor, tile_r: int = 256):
    """(N, 3) x 2 -> ((N', 8) rows [o, d, 0, 0] padded with zero rays to a
    multiple of ``tile_r``, N); a zero ray has det = 0 and never hits.  The
    JAX kernel's ray layout; the CUDA kernel reads o and d as they are."""
    n = o.shape[0]
    r = torch.cat([o, d, torch.zeros((n, 2), dtype=o.dtype, device=o.device)], dim=1)
    return torch.nn.functional.pad(r, (0, 0, 0, (-n) % tile_r)).contiguous(), n


def mt_closest_plain(tris_soa: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The kernel's plain version: ``closest_edges`` on the SoA's rows."""
    return closest_edges(tris_soa[0:3].T, tris_soa[3:6].T, tris_soa[6:9].T, o, d)


def _fn():
    return _cuda.library(NAME, "dod_mt_closest", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _fn_per_ray():
    return _cuda.library(NAME, "dod_mt_closest_per_ray",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _check(tris_soa, o, d) -> None:
    t_total = tris_soa.shape[-1]
    if tris_soa.dim() != 2 or t_total % TILE_T:
        raise ValueError(f"tris_soa has shape {tuple(tris_soa.shape)}: expected (9, a multiple of {TILE_T})")
    brute.check("tris_soa", tris_soa, (9, t_total), o, d)


@torch.no_grad()
def mt_closest(tris_soa: torch.Tensor, o: torch.Tensor, d: torch.Tensor, splits=None, stats=None):
    """Closest hit of every ray over all triangles -> (t (N,) f32, idx (N,)
    i32); a miss gives (inf, 0), and the lowest index wins a tie.

    ``tris_soa`` comes from ``swizzle_tris``: (9, T'), T' a multiple of
    ``TILE_T``.  t and idx are ``brute_force_closest``'s bits, whatever the
    split count.  For measurement on the card: ``splits`` overrides
    ``brute.splits``' choice, and ``stats``, a zeroed (2, 4) int64 CUDA
    tensor, takes the stats build's counts (rows ``brute.STATS_ROWS``,
    columns ``EXITS``).
    """
    if o.device.type == "cpu":
        return mt_closest_plain(tris_soa, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"mt_closest runs on cuda or cpu tensors, got {o.device}")
    _check(tris_soa, o, d)
    out = brute.launch(_fn(), NAME, tris_soa, o, d, splits, stats)
    if o.shape[0]:
        launches["closest"] += 1
    return out


@torch.no_grad()
def mt_closest_per_ray(tris_soa: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The same function by the kernel ``mt_closest`` replaced (one thread
    per ray over all T' triangles), for measurement only."""
    if o.device.type == "cpu":
        return mt_closest_plain(tris_soa, o, d)
    if o.device.type != "cuda":
        raise ValueError(f"mt_closest_per_ray runs on cuda or cpu tensors, got {o.device}")
    _check(tris_soa, o, d)
    out = brute.launch_per_ray(_fn_per_ray(), "mt_closest_per_ray", tris_soa, o, d)
    if o.shape[0]:
        per_ray_launches["closest"] += 1
    return out
