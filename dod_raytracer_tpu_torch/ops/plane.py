"""Batched ray-plane intersection.

Counterpart of ``dod_raytracer_tpu.ops.plane``: the reference's vectorized
plane test (``plane.cpp:27-139``),

  t = ((p0 - O) . n) / (d . n)
  valid = (|d . n| > eps) & (t > eps) & (t < clip)

with the stored normal reported unflipped (plane.cpp:134) and ties kept by
the lowest plane index.  Zero-normal padding planes fail the parallel test.
"""

from __future__ import annotations

import torch

from ..utils.math import safe_div
from .ray import INF, FamilyHit, take


def plane_candidate_t(point, normal, o, d, eps):
    """All-pairs candidate t: (N, P), +inf for invalid pairs."""
    denom = torch.sum(d[:, None, :] * normal[None, :, :], dim=-1)
    num = torch.sum((point[None, :, :] - o[:, None, :]) * normal[None, :, :], dim=-1)
    not_parallel = torch.abs(denom) > eps
    t = safe_div(num, denom, not_parallel)
    valid = not_parallel & (t > eps)
    return torch.where(valid, t, INF)


@torch.no_grad()
def plane_winner(planes, o, d, t_max, eps):
    """(idx (N,) int64, hit (N,) bool): each ray's closest plane, the first
    of equal candidates, and whether it lies strictly before ``t_max``."""
    t_all = plane_candidate_t(planes.point, planes.normal, o, d, eps)  # (N, P)
    idx = torch.argmin(t_all, dim=1)
    return idx, torch.gather(t_all, 1, idx[:, None])[:, 0] < t_max


def plane_hit(planes, o, d, idx, hit) -> FamilyHit:
    """The hit on plane ``idx`` (N,) where ``hit``, recomputed from its
    gathered row with gradient; t is +inf where not ``hit``."""
    p_w = take(planes.point, idx)
    n_w = take(planes.normal, idx)
    denom = torch.sum(d * n_w, dim=-1)
    num = torch.sum((p_w - o) * n_w, dim=-1)
    t = safe_div(num, denom, hit)
    t = torch.where(hit, t, INF)
    return FamilyHit(t=t, normal=n_w, color=take(planes.color, idx))


def intersect_planes(planes, o, d, t_max, eps) -> FamilyHit:
    return plane_hit(planes, o, d, *plane_winner(planes, o, d, t_max, eps))


def occluded_planes(planes, o, d, t_max, eps) -> torch.Tensor:
    t_all = plane_candidate_t(planes.point, planes.normal, o, d, eps)
    return torch.any(t_all < t_max[:, None], dim=1)
