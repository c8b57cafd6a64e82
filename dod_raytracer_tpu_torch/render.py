"""Whitted-style wavefront integrator.

Counterpart of ``dod_raytracer_tpu.render`` (the reference's per-pixel
recursion loop ``rayTrace``, ``main.cpp:273-347``): a wavefront of rays
advances bounce by bounce with inactive (missed) rays masked out.
Per-bounce semantics (main.cpp:312-334):

  weight  w_k = 2^-k
  final   = (1 - w_k) * final + w_k * (hit.color * lightingFactor)
  bounce  d' = reflect(d, n);  o' = hit + d' * Epsilon

and rays terminate at their first miss.  ``render_image`` renders the
frame in ray tiles, in 8x128 screen-block order when the frame divides
into such blocks (an exact permutation).  ``cfg.sort_bounces`` re-sorts
the wavefront every bounce by ``_sort_keys`` (another exact permutation)
so that the warp walks' warps hold neighbouring rays.
``cfg.remat_bounces`` recomputes each bounce in the backward
(``render_rays``); ``cfg.bounce_skip`` skips every bounce after the last
ray of the wavefront has terminated (an exact identity).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .camera import primary_rays
from .config import Config
from .intersect import _prefer_brute, closest_hit, remember
from .shading import lighting_factor
from .utils.math import reflect
from .utils.profiling import span

_BLOCK_H, _BLOCK_W = 8, 128


def _part1by2(v):
    """Spread 10 bits of v to every 3rd bit (Morton interleave helper)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _sort_keys(scene, o, d):
    """(N,) int32 sort key of the JAX package's ``_sort_keys``
    (``render.py:45-82``), bit for bit: a 9-bit direction bin (dominant
    face x 3+3-bit in-face u, v) over a 21-bit Morton code (7 bits an
    axis) of the origin inside the kd world bounds ([-6, 6]^3 without a
    tree).  A leaf-sharded scene keys on the whole scene's bounds, not
    its shard's, so that every rank of the shard group permutes its rays
    alike: the hit combine pairs the ranks' rays by position."""
    kd, shard = scene.kd, getattr(scene, "shard", None)
    if shard is not None:
        bmin, bmax = shard.bounds_min, shard.bounds_max
    elif kd is not None:
        bmin, bmax = kd.bounds_min, kd.bounds_max
    else:
        bmin = torch.full((3,), -6.0, device=o.device)
        bmax = torch.full((3,), 6.0, device=o.device)
    q = torch.clamp((o - bmin[None, :]) / torch.clamp_min(bmax - bmin, 1e-6)[None, :], 0.0, 1.0)
    cell = (q * 127.0).to(torch.int32)  # 7 bits/axis -> 21-bit morton
    morton = _part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1) | (_part1by2(cell[:, 2]) << 2)

    ad = torch.abs(d)
    axis = torch.argmax(ad, dim=1)  # dominant axis, the first of equal ones
    mx = torch.clamp_min(torch.amax(ad, dim=1), 1e-30)
    d_ax = torch.gather(d, 1, axis[:, None])[:, 0]
    face = axis * 2 + (d_ax < 0)  # 6 faces
    # the two minor components, in dominant-axis order
    others = torch.stack([d[:, 1], d[:, 2], d[:, 0]], dim=1)
    others2 = torch.stack([d[:, 2], d[:, 0], d[:, 1]], dim=1)
    u = torch.gather(others, 1, axis[:, None])[:, 0] / mx
    v = torch.gather(others2, 1, axis[:, None])[:, 0] / mx
    qu = torch.clamp(((u + 1.0) * 3.5).to(torch.int32), 0, 7)  # 3 bits
    qv = torch.clamp(((v + 1.0) * 3.5).to(torch.int32), 0, 7)
    dirbin = (face * 64 + qu * 8 + qv).to(torch.int32)  # 9 bits
    return dirbin * (1 << 21) + morton


def _bounce_perm(scene, o, d, active, cfg):
    """The permutation that re-sorts a bounce's wavefront (JAX
    ``render.py:94-113``): a stable sort on ``_sort_keys``, origin-major
    unless ``cfg.sort_dir_major``, killed rays last with
    ``cfg.sort_kill_tail``."""
    key = _sort_keys(scene, o.detach(), d.detach())
    if not getattr(cfg, "sort_dir_major", False):
        # origin-major variant: morton high bits, dirbin low
        key = (key & ((1 << 21) - 1)) * (1 << 9) + (key >> 21)
    if getattr(cfg, "sort_kill_tail", False):
        key = torch.where(active, key, 1 << 30)  # both key variants are < 2^30
    return torch.sort(key, stable=True).indices


# the backends whose frames the bounce sort made faster on the H100
# (chip_smoke.py phases 11 and 12, PERF.md §6); the mega frame (phase 7)
# and both binned frames (phase 13) were slower sorted
_SORTED_BACKENDS = ("packet", "forest")


def _sort_bounces(scene, cfg, device) -> bool:
    """``cfg.sort_bounces``; None = the port's own rule: on for CUDA
    tensors where a kd tree (not bypassed for brute force) is walked by
    a backend of ``_SORTED_BACKENDS``, off on the CPU and everywhere
    else.  The JAX package's rule differs: it sorts on its accelerator
    for every backend (``dod_raytracer_tpu/render.py:87-91``).  Both
    sorts are exact permutations, so no rule changes an image.

    A leaf-sharded scene resolves the backend once for the whole sharded
    tree (no treelet tables, every shard's nodes), which every rank of the
    shard group sees alike; its own shard may resolve otherwise."""
    sort = getattr(cfg, "sort_bounces", None)
    if sort is not None:
        return bool(sort)
    if torch.device(device).type != "cuda" or scene.kd is None:
        return False
    from .ops.traverse import _backend, resolve_backend

    shard = getattr(scene, "shard", None)
    if shard is not None:
        return resolve_backend(cfg, False, shard.n_nodes) in _SORTED_BACKENDS
    if _prefer_brute(scene, cfg):
        return False
    return _backend(scene.kd, cfg) in _SORTED_BACKENDS


def _bounce(scene, cfg, k: int, sort: bool, saved, o, d, pixel_dirs, final, active, slot_pix):
    """Bounce ``k`` of the wavefront (JAX ``render.py:93-131``): -> the next
    (o, d, pixel_dirs, final, active, slot_pix).  ``saved``: the bounce's
    discrete outputs under ``remat_bounces`` (``intersect.remember``)."""
    with span("render.bounce", k=k):
        if sort:
            with span("render.sort"):
                # every per-ray quantity rides along (an exact permutation)
                perm = remember(saved, "perm", lambda: _bounce_perm(scene, o, d, active, cfg))
                o, d, pixel_dirs, final, active, slot_pix = (
                    x[perm] for x in (o, d, pixel_dirs, final, active, slot_pix))
        # dead rays get t_max=-1: every intersection test rejects them
        t_max = torch.where(active, float("inf"), -1.0)
        hit = closest_hit(scene, o, d, cfg, t_max=t_max, saved=saved)
        active = active & hit.mask
        factor = lighting_factor(scene, hit.point, hit.normal, pixel_dirs, cfg, active, saved=saved)
        with span("render.blend"):
            color = hit.color * factor[:, None]
            w = 2.0 ** -k  # main.cpp:326
            blended = (1.0 - w) * final + w * color
            final = torch.where(active[:, None], blended, final)
            d_new = reflect(d, hit.normal)  # main.cpp:332
            o_new = hit.point + d_new * cfg.Epsilon  # main.cpp:333
            o = torch.where(active[:, None], o_new, o)
            d = torch.where(active[:, None], d_new, d)
        return o, d, pixel_dirs, final, active, slot_pix


def render_rays(scene, o, d, pixel_dirs, cfg: Config) -> torch.Tensor:
    """Trace a wavefront of rays to final linear RGB colors (N, 3).

    With ``cfg.remat_bounces`` and gradients on, each bounce is a
    ``torch.utils.checkpoint``: the backward recomputes the bounce from
    its inputs instead of keeping its shading tensors, and the recompute
    reads the bounce's permutation, closest-triangle winners and shadow
    bits back from the forward (the JAX package's
    ``save_only_these_names("traversal")``), so it launches no traversal
    or brute-force kernel.  The checkpoint's determinism check is off: it
    kept a dict and a ``Size`` of each saved tensor's shape until the
    backward, half of the Python objects a remat forward leaves alive,
    and those objects bring on the garbage collector's full passes
    (0.1-0.2 s each in the 1080p teapot shape fit); the recompute reads
    the traversal's outputs back, so its shapes cannot differ.

    With ``cfg.bounce_skip`` (JAX ``render.py:152-175``) each bounce first
    reads ``active.any()`` back to the host, and once no ray of the
    wavefront is active every later bounce, its sort included, is skipped
    whole: a dead bounce is an exact identity, since every update is
    masked by ``active``.  A skipped bounce adds nothing to the backward."""
    n = o.shape[0]
    sort = _sort_bounces(scene, cfg, o.device)
    # slot i of the (sorted) wavefront holds pixel slot_pix[i]
    state = (o, d, pixel_dirs, torch.zeros_like(o), torch.ones((n,), dtype=torch.bool, device=o.device),
             torch.arange(n, device=o.device) if sort else None)
    remat = getattr(cfg, "remat_bounces", False) and torch.is_grad_enabled()
    skip = getattr(cfg, "bounce_skip", False)
    for k in range(cfg.recursion_depth):
        if skip and not bool(state[4].any()):
            break  # no ray is active, so neither is any in a later bounce
        if remat:
            state = checkpoint(_bounce, scene, cfg, k, sort, {}, *state,
                               use_reentrant=False, preserve_rng_state=False, determinism_check="none")
        else:
            state = _bounce(scene, cfg, k, sort, None, *state)
    final, slot_pix = state[3], state[5]
    if sort:
        out = torch.empty_like(final)
        out[slot_pix] = final  # back to pixel order
        return out
    return final


def _auto_ray_tile(n: int, device) -> int:
    """ray_tile=0 (auto): 2^18 rays per tile on the card — one closest-hit
    launch then has 2048 blocks of 128 threads, enough to fill 132 SMs —
    and the JAX package's 32768 elsewhere."""
    return min(262144 if torch.device(device).type == "cuda" else 32768, n)


def _block_order(cfg) -> bool:
    return (getattr(cfg, "block_ray_order", True)
            and cfg.Width % _BLOCK_W == 0 and cfg.Height % _BLOCK_H == 0)


def _to_block_order(v, h: int, w: int):
    """(H*W, C) row-major -> screen-block-major (exactly invertible)."""
    c = v.shape[-1]
    v = v.reshape(h // _BLOCK_H, _BLOCK_H, w // _BLOCK_W, _BLOCK_W, c)
    return v.permute(0, 2, 1, 3, 4).reshape(h * w, c)


def _from_block_order(v, h: int, w: int):
    c = v.shape[-1]
    v = v.reshape(h // _BLOCK_H, w // _BLOCK_W, _BLOCK_H, _BLOCK_W, c)
    return v.permute(0, 2, 1, 3, 4).reshape(h * w, c)


def tile_size(cfg, n: int, device) -> int:
    """Rays per tile of an ``n``-ray render: ``cfg.ray_tile``, or the
    automatic size (``_auto_ray_tile``) for 0."""
    return min(cfg.ray_tile, n) if cfg.ray_tile else _auto_ray_tile(n, device)


def render_tiles(scene, cfg, o, d, d_raw, tile: int) -> torch.Tensor:
    """(N, 3) colors of the rays ``o``, ``d``, ``d_raw``, ``render_rays`` on
    ``tile`` rays at a time (the last tile may be shorter), without
    gradient."""
    parts = []
    with torch.no_grad():
        for i, s in enumerate(range(0, o.shape[0], tile)):
            with span("render.tile", tile=i):
                parts.append(render_rays(scene, o[s:s + tile], d[s:s + tile], d_raw[s:s + tile], cfg))
        return torch.cat(parts)


def frame_rays(cfg, device="cuda"):
    """Frame primary rays padded to a tile multiple: (o, d, d_raw, n, tile).

    Rays are in screen-block order when the frame divides into 8x128 pixel
    blocks; padding rays point down +z from the origin (their rows are
    dropped)."""
    o, d, d_raw = primary_rays(cfg.Width, cfg.Height, device=device)
    n = o.shape[0]
    if _block_order(cfg):
        d = _to_block_order(d, cfg.Height, cfg.Width)
        d_raw = _to_block_order(d_raw, cfg.Height, cfg.Width)
    tile = tile_size(cfg, n, device)
    pad = (-n) % tile
    if pad:
        fill = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(pad, 3)
        o = torch.cat([o, torch.zeros((pad, 3), device=device)])
        d = torch.cat([d, fill])
        d_raw = torch.cat([d_raw, fill])
    return o.contiguous(), d.contiguous(), d_raw.contiguous(), n, tile


def render_image(scene, cfg: Config, device="cuda") -> torch.Tensor:
    """Render the full frame to linear float RGB (H, W, 3) on ``device``,
    which must be the scene's device."""
    device = torch.device(device)
    if scene.device.type != device.type:
        raise ValueError(f"scene is on {scene.device}, render_image was asked for {device}")
    with span("render.frame"):
        o, d, d_raw, n, tile = frame_rays(cfg, scene.device)
        colors = render_tiles(scene, cfg, o, d, d_raw, tile)[:n]
        if _block_order(cfg):
            colors = _from_block_order(colors, cfg.Height, cfg.Width)
        return colors.reshape(cfg.Height, cfg.Width, 3)


def quantize_u8(img: torch.Tensor) -> np.ndarray:
    """clamp(c*255, 0, 255) then truncating u8 cast — toOutputChannelType
    (main.cpp:168-171) followed by glm's float->uint8 static_cast."""
    with span("render.to_host"):
        return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()
