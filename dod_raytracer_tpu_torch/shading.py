"""Whitted shading: ambient + Lambert + Phong + shadows.

Counterpart of ``dod_raytracer_tpu.shading`` (``getLightingFactor`` and its
helpers, ``main.cpp:156-244``):

  factor = 0.2                                      # shadeAmbientFactor :156-159
         + sum over visible lights of
             ( max(0, n . normalize(lp - p))        # shadeDiffuseFactor :161-166
             + max(0, reflect(ldir, n) . pixdir)^7  # shadeSpecularFactor :173-180
             ) * intensity / |lp - p|^2             # quadratic falloff :231-233

Reference quirks kept: the specular term dots against the original
un-normalized pixel direction at every bounce (main.cpp:328); glm's
reflect(L, N) = L - 2 (N.L) N with L toward the light; shadow ray origin
``hit + 0.01 * ldir`` (main.cpp:192).
"""

from __future__ import annotations

import torch

from .intersect import occluded, occluded_families, occluded_triangles, remember
from .utils.math import sqrt
from .utils.profiling import span

AMBIENT = 0.2  # main.cpp:158
SPECULAR_POW = 7.0  # main.cpp:178
SHADOW_OFFSET = 0.01  # main.cpp:192


def _batch_lights(cfg, device) -> bool:
    batch = getattr(cfg, "shadow_batch_lights", None)
    if batch is None:
        batch = device.type == "cuda"
    return batch


def _sort_shadow(scene, cfg) -> bool:
    """``cfg.sort_shadow``; None = the JAX package's rule on every
    device: on over trees of 1,024 or more leaf blocks.  A leaf-sharded
    scene counts the blocks of every shard, the same count on every rank
    of the shard group (whose rays must be permuted alike)."""
    sort = getattr(cfg, "sort_shadow", None)
    if sort is None:
        shard = getattr(scene, "shard", None)
        if shard is not None:
            return shard.n_blocks >= 1024
        kd = scene.kd
        return kd is not None and kd.block_g is not None and kd.block_g.shape[0] >= 1024
    return bool(sort)


def _forward_key(scene, o, d, t_max):
    """Forward shadow rays: the 21-bit hit-point Morton code, killed pairs
    (t_max < 0) at 1 << 21 -> (key, light segment 1 << 22)."""
    from .render import _sort_keys

    key = _sort_keys(scene, o, d) & ((1 << 21) - 1)
    return torch.where(t_max < 0.0, 1 << 21, key), 1 << 22


def _reversed_key(scene, o, d, t_max):
    """Reversed shadow rays share their light's origin, so they group by
    direction: the 9-bit direction bin of the *forward* rays ``o``, ``d``,
    killed pairs of the reversed window ``t_max`` at 1 << 10 -> (key,
    light segment 1 << 11) (JAX ``shading.py:131-145``)."""
    from .render import _sort_keys

    key = _sort_keys(scene, o, d) >> 21
    return torch.where(t_max < 0.0, 1 << 10, key), 1 << 11


def _shadow_perm(scene, o, d, t_max, n_lights: int, key_rule=_forward_key):
    """The permutation that groups each light's shadow rays by
    ``key_rule`` (JAX ``shading.py:122-146``): a stable sort on the key,
    killed pairs at the tail of their light's segment."""
    key, seg = key_rule(scene, o, d, t_max)
    light_ix = torch.arange(n_lights, dtype=torch.int32, device=o.device).repeat_interleave(o.shape[0] // n_lights)
    return torch.sort(key + light_ix * seg, stable=True).indices


def shadow_rays(scene, points, active=None, relevant=None):
    """The flattened (L*N,) shadow wavefront: (o, d, t_max), light-major.

    ``t_max`` is the distance to the light, or -1 for rays masked out by
    ``active`` (N,) or by ``relevant`` (N, L): -1 makes every occlusion
    test reject them at once.
    """
    with span("shade.rays"):
        lp = scene.lights.position  # (L, 3)
        L, n = lp.shape[0], points.shape[0]
        to_light = lp[:, None, :] - points[None, :, :]  # (L, N, 3)
        dist = sqrt(torch.sum(to_light * to_light, dim=-1))  # (L, N)
        ldir = to_light / torch.clamp_min(dist, 1e-30)[..., None]
        o = points[None, :, :] + ldir * SHADOW_OFFSET
        kill = torch.zeros((L, n), dtype=torch.bool, device=points.device)
        if active is not None:
            kill = kill | ~active[None, :]
        if relevant is not None:
            kill = kill | ~relevant.T
        dist = torch.where(kill, -1.0, dist)
        return o.reshape(L * n, 3), ldir.reshape(L * n, 3), dist.reshape(L * n)


def reversed_rays(scene, d):
    """The triangle half of the reversed shadow wavefront (JAX
    ``shading.py:100-121``) from the forward one's directions ``d``
    (L*N, 3), light-major: origins just past each light, ``light +
    0.01 * d``, and directions ``-d`` -> (o, d).  With the forward window
    (0, t_max) the segment is the forward one in exact arithmetic; f32
    rounds the reversed intersection otherwise, so a grazing occluder can
    flip."""
    with span("shade.rays"):
        lp = scene.lights.position
        o = lp.repeat_interleave(d.shape[0] // lp.shape[0], dim=0) + d * SHADOW_OFFSET
        return o, -d


@torch.no_grad()
def light_visibility(scene, points, cfg, active=None, relevant=None) -> torch.Tensor:
    """(N, L) bool — canSeeLight (main.cpp:182-219) for all rays x lights.

    Two execution shapes with identical visibility bits (occlusion is
    elementwise over rays): one any-hit query over the flattened (L*N,)
    shadow wavefront (``shadow_batch_lights``), sorted per light where
    ``_sort_shadow`` says so (an exact permutation), or L sequential N-ray
    queries.  Pairs masked out by ``active`` or ``relevant`` report
    *visible*; callers only mask pairs whose contribution is exactly zero.

    ``cfg.shadow_reverse`` (batched only; the per-light loop ignores it,
    as JAX's does) tests the sphere, plane and cylinder families on the
    forward rays, whose origin the reference's origin-inside sphere quirk
    must see, and the triangles on ``reversed_rays``, pairs a family
    already blocks killed; the sort then groups each light's rays by
    direction bin (``_reversed_key``) instead of hit point.
    """
    if _batch_lights(cfg, points.device):
        o, d, t = shadow_rays(scene, points, active, relevant)
        qo, qd, family = o, d, None
        query, key_rule = occluded, _forward_key
        if getattr(cfg, "shadow_reverse", None):
            family = occluded_families(scene, o, d, t, cfg)
            t = torch.where(family, -1.0, t)
            qo, qd = reversed_rays(scene, d)
            query, key_rule = occluded_triangles, _reversed_key
        if _sort_shadow(scene, cfg):
            with span("shade.sort"):
                # the key is computed on the forward rays in both rules
                perm = _shadow_perm(scene, o, d, t, scene.lights.position.shape[0], key_rule)
                qo, qd, qt = qo[perm], qd[perm], t[perm]
                blocked = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
            sorted_blocked = query(scene, qo, qd, qt, cfg)
            with span("shade.sort"):
                blocked[perm] = sorted_blocked
        else:
            blocked = query(scene, qo, qd, t, cfg)
        if family is not None:
            blocked = blocked | family
        return ~blocked.reshape(-1, points.shape[0]).T

    kill0 = torch.zeros(points.shape[:1], dtype=torch.bool, device=points.device)
    if active is not None:
        kill0 = kill0 | ~active
    blocked = []
    for li in range(scene.lights.position.shape[0]):
        to_light = scene.lights.position[li][None, :] - points  # (N, 3)
        dist = sqrt(torch.sum(to_light * to_light, dim=-1))
        ldir = to_light / torch.clamp_min(dist, 1e-30)[:, None]
        o = points + ldir * SHADOW_OFFSET
        kill = kill0 if relevant is None else kill0 | ~relevant[:, li]
        dist = torch.where(kill, -1.0, dist)
        blocked.append(occluded(scene, o, ldir, dist, cfg))
    return ~torch.stack(blocked, dim=1)


def light_terms(scene, points, normals, pixel_dirs):
    """Per (ray, light) shading terms: ((diffuse + specular) (N, L),
    distance factor (N, L)).  A pair whose first term is 0 contributes
    nothing, so it needs no shadow ray."""
    lp = scene.lights.position  # (L, 3)
    li = scene.lights.intensity  # (L,)
    to_light = lp[None, :, :] - points[:, None, :]  # (N, L, 3)
    dist_sq = torch.clamp_min(torch.sum(to_light * to_light, dim=-1), 1e-30)
    ldir = to_light * torch.rsqrt(dist_sq)[..., None]
    dist_factor = li[None, :] / dist_sq  # main.cpp:233

    n_dot_l = torch.sum(normals[:, None, :] * ldir, dim=-1)
    diffuse = torch.clamp_min(n_dot_l, 0.0)  # :164
    refl = ldir - 2.0 * n_dot_l[..., None] * normals[:, None, :]  # glm::reflect(ldir, n)
    spec_dot = torch.clamp_min(torch.sum(refl * pixel_dirs[:, None, :], dim=-1), 0.0)  # :178
    specular = spec_dot ** SPECULAR_POW
    return diffuse + specular, dist_factor


def lighting_factor(scene, points, normals, pixel_dirs, cfg, active=None, saved=None) -> torch.Tensor:
    """(N,) scalar lighting factor (getLightingFactor, main.cpp:221-244).

    ``pixel_dirs`` is the un-normalized primary direction (parity quirk).
    ``active`` masks rays whose shadow queries are skipped (their
    visibility is forced False).  Pairs with exactly zero Lambert + Phong
    term launch no shadow ray: their visibility is multiplied by zero.
    Visibility is a step function without gradient (the JAX package's
    stop_gradient, ``shading.py:214-216``), so the shadow pass gets the
    points detached; ``saved`` keeps its bits for a bounce's recompute
    (``intersect.remember``).
    """
    with span("shade.terms"):
        shade, dist_factor = light_terms(scene, points, normals, pixel_dirs)
        relevant = shade.detach() > 0.0  # (N, L)
    visible = remember(saved, "visible", lambda: light_visibility(
        scene, points.detach(), cfg, active, relevant))  # (N, L)
    with span("shade.terms"):
        if active is not None:
            visible = visible & active[:, None]
        per_light = torch.where(visible, shade * dist_factor, 0.0)
        return AMBIENT + torch.sum(per_light, dim=-1)
