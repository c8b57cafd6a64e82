"""Axis-aligned bounding-box slab test.

Counterpart of ``dod_raytracer_tpu.ops.aabb``: ``AxisAlignedBoundingBox::
intersect`` (``box.cpp:33-53``) including its NaN behavior — when a ray
origin lies exactly on a slab with a parallel direction, 0 * inf = NaN
comparisons are False so the slab is skipped, like the C++ ternaries.
"""

from __future__ import annotations

import torch


def slab_test(bounds_min, bounds_max, o, inv_d, t_clip):
    """Batched slab test against a single box.

    Args:
      bounds_min, bounds_max: (3,) box corners.
      o: (N, 3) ray origins; inv_d: (N, 3) 1/direction (+-inf allowed).
      t_clip: (N,) initial tmax (the clipping distance, box.cpp:36).
    Returns:
      (hit (N,) bool, tmin (N,), tmax (N,)).
    """
    tmin = torch.zeros(o.shape[:-1], dtype=o.dtype, device=o.device)
    tmax = t_clip
    hit = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for axis in range(3):
        t_near = (bounds_min[axis] - o[..., axis]) * inv_d[..., axis]
        t_far = (bounds_max[axis] - o[..., axis]) * inv_d[..., axis]
        swap = t_near > t_far  # NaN -> False, like std::swap guard box.cpp:43
        t_near, t_far = torch.where(swap, t_far, t_near), torch.where(swap, t_near, t_far)
        tmin = torch.where(t_near > tmin, t_near, tmin)  # NaN -> keep (box.cpp:46)
        tmax = torch.where(t_far < tmax, t_far, tmax)
        hit = hit & ~(tmin > tmax)
    return hit, tmin, tmax
