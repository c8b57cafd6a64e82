"""Batched finite capped-cylinder intersection.

Counterpart of ``dod_raytracer_tpu.ops.cylinder``: the reference's scalar
cylinder path (``cylinder.cpp:35-210``) — per cylinder the quadratic body
test (cylinder.cpp:76-118) and two cap discs at offsets 0 and height
(cylinder.cpp:120-152), fused by a first-occurrence strict min in
candidate order [body, bottom cap, top cap], cylinders in creation order.

  body:  discriminant >= eps; t = minNonNegative(tSub, tAdd) finite;
         0 <= dot(hit - base, axis) <= height
  disc:  |d . axis| >= eps; eps <= t <= clip; |hit - center|^2 <= r^2
  body normal: normalize(hit - base - axis * dot(hit - base, axis))
  disc normal: -axis if d . axis > 0 else axis  (cylinder.cpp:150)

The reference drops the hit color on cylinder hits (cylinder.cpp:204-207
commented out); ``color_bug=True`` (cfg.replicate_reference_bugs)
reproduces its black cylinders.
"""

from __future__ import annotations

import torch

from ..utils.math import dot, safe_div, safe_sqrt
from .ray import INF, FamilyHit, take


def _min_non_negative(t_sub, t_add):
    """minNonNegative (cylinder.cpp:8-26): inf when both negative."""
    return torch.where(
        (t_sub < 0.0) & (t_add < 0.0), INF,
        torch.where(t_sub < 0.0, t_add,
                    torch.where(t_add < 0.0, t_sub, torch.minimum(t_sub, t_add))),
    )


def cylinder_candidate_t(cyl, o, d, t_max, eps, n_valid=None):
    """Candidates (N, C, 3) in order [body, discA(0), discB(height)].

    ``n_valid``: count of real (non-padding) cylinders; padded columns are
    masked to +inf.
    """
    base, axis = cyl.base, cyl.axis  # (C,3)
    r_sq = (cyl.radius * cyl.radius)[None, :]  # (1,C)
    height = cyl.height[None, :]

    o_b = o[:, None, :]  # (N,1,3)
    d_b = d[:, None, :]
    ax = axis[None, :, :]  # (1,C,3)

    # --- body (cylinder.cpp:76-118) ---
    delta_p = o_b - base[None, :, :]
    d_dot_a = torch.sum(d_b * ax, dim=-1)  # (N,C)
    v_rem = d_b - d_dot_a[..., None] * ax
    dp_dot_a = torch.sum(delta_p * ax, dim=-1)
    dp_rem = delta_p - dp_dot_a[..., None] * ax

    a = torch.sum(v_rem * v_rem, dim=-1)
    b = 2.0 * torch.sum(v_rem * dp_rem, dim=-1)
    c = torch.sum(dp_rem * dp_rem, dim=-1) - r_sq
    disc = b * b - 4.0 * a * c
    disc_ok = disc >= eps  # reference: disc < eps -> miss (cylinder.cpp:87)
    sq = safe_sqrt(torch.where(disc_ok, disc, 0.0))
    inv_2a = safe_div(torch.ones_like(a), 2.0 * a, disc_ok & (a != 0.0))
    t_sub = (-b - sq) * inv_2a
    t_add = (-b + sq) * inv_2a
    t_body = _min_non_negative(t_sub, t_add)
    body_finite = disc_ok & (a != 0.0) & torch.isfinite(t_body)
    hit_pt = o_b + d_b * torch.where(body_finite, t_body, 0.0)[..., None]
    axis_factor = torch.sum((hit_pt - base[None, :, :]) * ax, dim=-1)
    body_ok = body_finite & (axis_factor >= 0.0) & (axis_factor <= height)
    t_body = torch.where(body_ok, t_body, INF)

    # --- caps (cylinder.cpp:120-152) ---
    def disc_t(offset):
        center = base[None, :, :] + ax * offset[..., None]
        denom = d_dot_a
        not_par = torch.abs(denom) >= eps
        t = safe_div(torch.sum((center - o_b) * ax, dim=-1), denom, not_par)
        ok = not_par & (t >= eps) & (t <= t_max[:, None])
        pt = o_b + d_b * torch.where(ok, t, 0.0)[..., None]
        on_plane = pt - center
        ok = ok & (torch.sum(on_plane * on_plane, dim=-1) <= r_sq)
        return torch.where(ok, t, INF)

    t_disc_a = disc_t(torch.zeros_like(height))
    t_disc_b = disc_t(height)

    cand = torch.stack([t_body, t_disc_a, t_disc_b], dim=-1)  # (N, C, 3)
    if n_valid is not None and n_valid < cyl.base.shape[0]:
        col_ok = torch.arange(cyl.base.shape[0], device=o.device) < n_valid
        cand = torch.where(col_ok[None, :, None], cand, INF)
    return cand


@torch.no_grad()
def cylinder_winner(cyl, o, d, t_max, eps, n_valid=None):
    """(idx (N,) int64, hit (N,) bool): each ray's closest candidate in
    ``cylinder_candidate_t``'s flat order (cylinder ``idx // 3``, kind
    ``idx % 3``: 0 body, 1 disc A, 2 disc B), the first of equal ones, and
    whether it lies strictly before ``t_max``."""
    flat = cylinder_candidate_t(cyl, o, d, t_max, eps, n_valid).reshape(o.shape[0], -1)  # ref order
    idx = torch.argmin(flat, dim=1)
    return idx, torch.gather(flat, 1, idx[:, None])[:, 0] < t_max


def cylinder_hit(cyl, o, d, ci, kind, hit, color_bug: bool = False) -> FamilyHit:
    """The hit on candidate ``kind`` (N,) of cylinder ``ci`` (N,) where
    ``hit``, recomputed from the gathered rows with gradient; t is +inf
    where not ``hit``."""
    base_w, axis_w = take(cyl.base, ci), take(cyl.axis, ci)
    r_w, h_w = take(cyl.radius, ci), take(cyl.height, ci)

    # recompute of the winning candidate's t (same branch as the forward)
    d_dot_a = dot(d, axis_w)
    is_body = kind == 0
    delta_p = o - base_w
    v_rem = d - d_dot_a[:, None] * axis_w
    dp_rem = delta_p - dot(delta_p, axis_w)[:, None] * axis_w
    a = dot(v_rem, v_rem)
    b = 2.0 * dot(v_rem, dp_rem)
    c = dot(dp_rem, dp_rem) - r_w * r_w
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(torch.where(is_body & hit, disc, 1.0))
    inv_2a = safe_div(torch.ones_like(a), 2.0 * a, is_body & hit)
    t_body = _min_non_negative((-b - sq) * inv_2a, (-b + sq) * inv_2a)
    # cap t
    off = torch.where(kind == 2, h_w, 0.0)
    center = base_w + axis_w * off[:, None]
    t_cap = safe_div(dot(center - o, axis_w), d_dot_a, (~is_body) & hit)
    t = torch.where(is_body, t_body, t_cap)
    t = torch.where(hit, t, INF)

    point = o + d * torch.where(hit, t, 0.0)[:, None]
    # body normal (cylinder.cpp:113-116)
    ax_fac = dot(point - base_w, axis_w)
    radial = point - base_w - axis_w * ax_fac[:, None]
    rad_sq = torch.clamp_min(dot(radial, radial), 1e-30)
    n_body = radial * torch.rsqrt(rad_sq)[:, None]
    # disc normal (cylinder.cpp:150)
    n_disc = torch.where((d_dot_a > 0.0)[:, None], -axis_w, axis_w)
    normal = torch.where(is_body[:, None], n_body, n_disc)

    color = torch.zeros_like(take(cyl.color, ci)) if color_bug else take(cyl.color, ci)
    return FamilyHit(t=t, normal=normal, color=color)


def intersect_cylinders(cyl, o, d, t_max, eps, color_bug: bool = False, n_valid=None) -> FamilyHit:
    idx, hit = cylinder_winner(cyl, o, d, t_max, eps, n_valid)
    return cylinder_hit(cyl, o, d, idx // 3, idx % 3, hit, color_bug)


def occluded_cylinders(cyl, o, d, t_max, eps, n_valid=None) -> torch.Tensor:
    t_cand = cylinder_candidate_t(cyl, o, d, t_max, eps, n_valid)
    return torch.any(t_cand.reshape(o.shape[0], -1) < t_max[:, None], dim=1)
