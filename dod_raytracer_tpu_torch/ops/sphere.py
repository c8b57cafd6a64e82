"""Batched ray-sphere intersection.

Counterpart of ``dod_raytracer_tpu.ops.sphere``: the reference's AVX
geometric test (``sphere.cpp:26-160``) as an ``(N rays) x (S spheres)``
broadcast, with the vectorized path's validity mask

  valid = (|L|^2 > r^2)          # ray origin strictly outside (sphere.cpp:70)
        & (d2   < r^2)           # closest approach inside      (sphere.cpp:88)
        & (t0 >= 0) & (t1 >= 0)  # sphere fully in front       (sphere.cpp:103-105)
  t = min(t0, t1)

and a hit only strictly below the incoming clipping distance
(sphere.cpp:127,134).  Ties keep the lowest sphere index (argmin's first
occurrence).  The winner's t and normal are recomputed from the gathered
sphere, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..utils.math import dot, safe_sqrt
from .ray import INF, FamilyHit, take


def sphere_candidate_t(center, radius, o, d):
    """All-pairs candidate t: (N, S) with +inf for invalid pairs."""
    L = center[None, :, :] - o[:, None, :]  # (N, S, 3)
    dist_sq = torch.sum(L * L, dim=-1)
    r_sq = (radius * radius)[None, :]
    tca = torch.sum(L * d[:, None, :], dim=-1)
    d2 = dist_sq - tca * tca
    thc = safe_sqrt(r_sq - d2)
    t0 = tca - thc
    t1 = tca + thc
    valid = (dist_sq > r_sq) & (d2 < r_sq) & (t0 >= 0.0) & (t1 >= 0.0)
    return torch.where(valid, torch.minimum(t0, t1), INF)


def _recompute_t(center_w, radius_w, o, d, valid):
    """t for the already-selected sphere (N, 3)/(N,)."""
    L = center_w - o
    dist_sq = dot(L, L)
    r_sq = radius_w * radius_w
    tca = dot(L, d)
    d2 = dist_sq - tca * tca
    thc = safe_sqrt(torch.where(valid, r_sq - d2, 1.0))
    return tca - thc  # == min(t0, t1) given t0,t1 >= 0


@torch.no_grad()
def sphere_winner(spheres, o, d, t_max):
    """(idx (N,) int64, hit (N,) bool): each ray's closest sphere, the first
    of equal candidates, and whether it lies strictly before ``t_max``.
    Discrete, so computed without gradient."""
    t_all = sphere_candidate_t(spheres.center, spheres.radius, o, d)  # (N, S)
    idx = torch.argmin(t_all, dim=1)
    return idx, torch.gather(t_all, 1, idx[:, None])[:, 0] < t_max


def sphere_hit(spheres, o, d, idx, hit) -> FamilyHit:
    """The hit on sphere ``idx`` (N,) where ``hit``, recomputed from its
    gathered row with gradient; t is +inf where not ``hit``."""
    center_w = take(spheres.center, idx)
    radius_w = take(spheres.radius, idx)
    t = _recompute_t(center_w, radius_w, o, d, hit)
    t = torch.where(hit, t, INF)

    point = o + d * torch.where(hit, t, 0.0)[:, None]
    # hitNormal = normalize(hitPoint - center) (sphere.cpp:157)
    delta = point - center_w
    nrm_sq = torch.clamp_min(dot(delta, delta), 1e-30)
    normal = delta * torch.rsqrt(nrm_sq)[:, None]
    return FamilyHit(t=t, normal=normal, color=take(spheres.color, idx))


def intersect_spheres(spheres, o, d, t_max) -> FamilyHit:
    """Closest hit over the sphere family (padding radius 0 never hits).

    ``t_max``: (N,) incoming clipping distance (strict upper bound).
    """
    return sphere_hit(spheres, o, d, *sphere_winner(spheres, o, d, t_max))


def occluded_spheres(spheres, o, d, t_max) -> torch.Tensor:
    """Any-hit query: does any sphere hit strictly before t_max?"""
    t_all = sphere_candidate_t(spheres.center, spheres.radius, o, d)
    return torch.any(t_all < t_max[:, None], dim=1)
