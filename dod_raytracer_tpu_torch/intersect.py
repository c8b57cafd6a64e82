"""Scene-level closest-hit and any-hit queries.

Counterpart of ``dod_raytracer_tpu.intersect``: the per-family kernels
fused with the reference main loop's chaining protocol (``main.cpp:314-321``)
— families in the order sphere -> plane -> cylinder -> triangles (kd
tree), each clipped at the running closest t, a later family winning only
on a strictly smaller t.  The kd walk receives the clip tightened by the
cheap families first.
"""

from __future__ import annotations

import torch

from .ops import families as family_ops
from .ops import triangle as tri_ops
from .ops.ray import INF, FamilyHit, Hit, closer, miss_like
from .utils.profiling import count, span


def _prefer_brute(scene, cfg) -> bool:
    """Small-mesh crossover: meshes with <= cfg.brute_threshold triangles
    bypass the kd walk for the brute-force intersector (0 = never)."""
    thr = int(getattr(cfg, "brute_threshold", 0))
    return 0 < scene.n_triangles <= thr


def _leaf_shard(scene, cfg):
    """The scene's ``LeafShard`` when ``cfg.tri_shard_axis`` is set (the
    JAX package's dispatch, ``intersect.py:38-42``), else None.  Raises
    ``ValueError`` where the two disagree: an axis set on a scene that
    carries no process group for it, or a sharded scene without the axis
    (its kd tree holds one shard of the triangles)."""
    axis, shard = getattr(cfg, "tri_shard_axis", ""), getattr(scene, "shard", None)
    if not axis:
        if shard is not None:
            raise ValueError(f"a scene leaf-sharded over {shard.axis!r} needs cfg.tri_shard_axis")
        return None
    if shard is None or shard.axis != axis:
        raise ValueError(f"tri_shard_axis={axis!r}: the scene carries no process group for that axis "
                         "(build it with parallel.leaf_shard.make_leaf_sharded_scene)")
    return shard


def remember(saved, key: str, fn):
    """``fn()``, kept in ``saved[key]`` for a recompute to read back.

    ``saved`` is one bounce's dict under ``remat_bounces`` (None
    otherwise): the forward computes each discrete traversal output once
    and stores it; the backward's recompute of the bounce reads it back
    and launches no traversal kernel, as the JAX package's
    ``save_only_these_names("traversal")`` policy saves them.  The
    families' closest hit is not kept: its kernel runs again (4 B a ray a
    bounce would outlive the forward)."""
    if saved is None:
        return fn()
    if key not in saved:
        saved[key] = fn()
    return saved[key]


@torch.no_grad()
def _closest_triangle(scene, o, d, t_max, cfg):
    """(idx (N,), hit (N,) bool): each ray's closest triangle, by the kd
    walk or brute force.  Discrete, so computed without gradient: the JAX
    package's stop_gradient on the vertices and the rays
    (``intersect.py:44-70``)."""
    with span("hit.triangles"):
        o, d, t_max = o.detach(), d.detach(), t_max.detach()
        if scene.kd is not None and not _prefer_brute(scene, cfg):
            from .ops.traverse import kd_closest

            _, idx, hit = kd_closest(scene.kd, scene.triangles, o, d, t_max, cfg)
            return idx, hit
        # the brute-force branch, the only one that reads triangle_backend
        # (the JAX package's intersect.py:54-70); names other than these two
        # take the torch brute force there too
        backend = getattr(cfg, "triangle_backend", "jnp")
        verts = scene.triangles.verts.detach()
        if backend == "plucker":
            from .ops.plucker import plucker_closest, plucker_pack

            t_best, idx = plucker_closest(plucker_pack(verts), o.contiguous(), d.contiguous())
        elif backend == "pallas":
            from .ops.mt import mt_closest, swizzle_tris

            t_best, idx = mt_closest(swizzle_tris(verts), o.contiguous(), d.contiguous())
        else:
            t_best, idx = tri_ops.brute_force_closest(verts, o, d)
        return idx, t_best < t_max


def _triangles_closest(scene, o, d, t_max, cfg, saved=None) -> FamilyHit:
    """The closest triangle's hit: the winner from ``_closest_triangle``
    (or, in a recompute, from ``saved``), its hit recomputed with gradient
    by ``triangle_hit_attrs``.  A set ``cfg.tri_shard_axis`` always takes
    the leaf-sharded kd walk and its combine over the shard group
    (``parallel.leaf_shard``), whatever ``brute_threshold`` says."""
    if scene.n_triangles == 0:
        return miss_like(o.shape[0], o.device)
    if _leaf_shard(scene, cfg) is not None:
        from .parallel.leaf_shard import sharded_triangles_closest

        return sharded_triangles_closest(scene, o, d, t_max, cfg, cfg.tri_shard_axis, saved)
    first = saved is None or "triangles" not in saved  # not a remat recompute
    idx, hit = remember(saved, "triangles", lambda: _closest_triangle(scene, o, d, t_max, cfg))
    with span("hit.attrs"):
        if first and torch.is_grad_enabled() and scene.triangles.verts.requires_grad:
            count("grad.geom.rows", idx.shape[0])  # rows whose hit carries gradient to the vertices
        return tri_ops.triangle_hit_attrs(scene.triangles, o, d, idx, hit, scene.mesh_colors)


def _triangles_occluded(scene, o, d, t_max, cfg) -> torch.Tensor:
    with span("shadow.triangles"):
        if scene.n_triangles == 0:
            return torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
        if _leaf_shard(scene, cfg) is not None:
            from .parallel.leaf_shard import sharded_triangles_occluded

            return sharded_triangles_occluded(scene, o, d, t_max, cfg, cfg.tri_shard_axis)
        if scene.kd is not None and not _prefer_brute(scene, cfg):
            from .ops.traverse import kd_any

            return kd_any(scene.kd, scene.triangles, o, d, t_max, cfg)
        # any-hit never reads triangle_backend: the JAX package has no any-hit
        # brute-force kernel; no gradient, as JAX's stop_gradient (intersect.py:86)
        with torch.no_grad():
            return tri_ops.occluded_triangles_brute(scene.triangles.verts.detach(), o.detach(), d.detach(),
                                                    t_max.detach())


def closest_families(scene, o, d, cfg, t_max) -> FamilyHit:
    """Closest hit over the non-triangle families only (sphere -> plane ->
    cylinder): one launch of ``csrc/families_closest.cu`` for CUDA
    tensors, its plain version for CPU tensors; the hit carries gradient
    as its inputs ask (``ops/families.py`` ``closest``).
    ``minimum(result.t, t_max)`` is the clip the triangle query receives
    in ``closest_hit``."""
    with span("hit.families"):
        return family_ops.closest(scene, o, d, t_max, cfg.Epsilon, cfg.replicate_reference_bugs)


def closest_hit(scene, o, d, cfg, t_max=None, saved=None) -> Hit:
    """Globally closest hit across all families (the per-pixel family chain
    of main.cpp:312-321 collapsed into one fused reduction).  ``saved``:
    see ``remember``."""
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    best = closest_families(scene, o, d, cfg, t_max)
    tri = _triangles_closest(scene, o, d, torch.minimum(best.t, t_max), cfg, saved)
    with span("render.blend"):
        best = closer(best, tri)
        mask = best.t < t_max
        t_safe = torch.where(mask, best.t, 0.0)
        point = o + d * t_safe[:, None]
        return Hit(t=best.t, point=point, normal=best.normal, color=best.color, mask=mask)


def occluded_families(scene, o, d, t_max, cfg) -> torch.Tensor:
    """Any-hit over the non-triangle families only: one launch of
    ``csrc/families_any.cu`` for CUDA tensors, its plain version (the
    sphere, plane and cylinder tests in torch) for CPU tensors
    (``ops/families.py``)."""
    with span("shadow.families"):
        return family_ops.occluded_any(scene, o, d, t_max, cfg.Epsilon)


def occluded_triangles(scene, o, d, t_max, cfg) -> torch.Tensor:
    """Any-hit over the triangle mesh only."""
    return _triangles_occluded(scene, o, d, t_max, cfg)


def occluded(scene, o, d, t_max, cfg) -> torch.Tensor:
    """Any-hit visibility query: True where something blocks strictly before
    t_max (canSeeLight's family chain, main.cpp:198-218, as one OR).

    Rays already blocked by a cheap family skip the kd walk (t_max=-1 kills
    them at the root slab test); the OR is unchanged."""
    blocked = occluded_families(scene, o, d, t_max, cfg)
    t_tri = torch.where(blocked, -1.0, t_max)
    return blocked | _triangles_occluded(scene, o, d, t_tri, cfg)
