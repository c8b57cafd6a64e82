"""Data-parallel rendering and training over a 'dp' axis of ranks.

Counterpart of ``dod_raytracer_tpu.parallel.sharding``.  The reference
splits the frame into row blocks over pthreads with a shared framebuffer
(``main.cpp:371-394``); the JAX package shards the primary rays over a
mesh axis inside ``shard_map`` with the scene replicated.  Here every
rank holds the whole scene (``replicate_scene``), renders its contiguous
share of the row-major primary rays, and the frame is assembled over the
dp group; the train step all-reduces each parameter gradient over it.

Gloo takes all-reduce and broadcast of CUDA tensors but not every other
collective, so the frame is assembled by an all-reduce SUM of the ranks'
disjoint slices (each rank's rows, zeros elsewhere): exact, since every
pixel has one non-zero term.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from ..camera import primary_rays
from ..render import render_rays, render_tiles, tile_size
from .multihost import Mesh, global_mesh


def make_mesh(n_devices: int | None = None, axis: str = "dp", device="cuda") -> Mesh:
    """1D mesh over the world's ranks (``initialize`` first); ``n_devices``,
    if given, must be the world size."""
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError(f"a mesh of {n_devices} ranks in a world of {dist.get_world_size()}")
    return global_mesh((axis,), device=device)


def _pad_to(x, multiple: int):
    """Pad rows to a multiple by repeating the last row (JAX ``sharding.py:46-53``)
    -> (padded, pad)."""
    pad = (-x.shape[0]) % multiple
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
    return x, pad


def local_rows(x, mesh: Mesh, axis: str):
    """This rank's contiguous share of rows ``x`` (a multiple of the axis size)."""
    n = x.shape[0] // mesh.shape[axis]
    i = mesh.coords[axis]
    return x[i * n:(i + 1) * n]


def gather_rows(local, mesh: Mesh, axis: str):
    """The axis's ranks' ``local`` rows in rank order, on every rank of the
    group (an all-reduce SUM of disjoint slices, module docstring)."""
    n, k = local.shape[0], mesh.shape[axis]
    out = local.new_zeros((k * n,) + tuple(local.shape[1:]))
    i = mesh.coords[axis]
    out[i * n:(i + 1) * n] = local
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return out


def render_share(scene, cfg, mesh: Mesh, axis: str, o, d, d_raw):
    """Render this rank's share of the padded rays through
    ``render.render_tiles`` and gather the axis's shares -> (N, 3)."""
    o, d, d_raw = (local_rows(x, mesh, axis) for x in (o, d, d_raw))
    colors = render_tiles(scene, cfg, o, d, d_raw, tile_size(cfg, o.shape[0], o.device))
    return gather_rows(colors, mesh, axis)


def render_image_sharded(scene, cfg, mesh: Mesh, axis: str = "dp"):
    """Data-parallel full-frame render: rays sharded over ``axis``, the
    scene replicated -> (H, W, 3) on every rank, on the scene's device."""
    o, d, d_raw = primary_rays(cfg.Width, cfg.Height, device=scene.device)
    n, k = o.shape[0], mesh.shape[axis]
    o, d, d_raw = (_pad_to(x, k)[0] for x in (o, d, d_raw))
    return render_share(scene, cfg, mesh, axis, o, d, d_raw)[:n].reshape(cfg.Height, cfg.Width, 3)


def tiled_loss_backward(scene, cfg, o, d, d_raw, target, denom: float) -> torch.Tensor:
    """sum((render_rays - target)^2) / denom over tiles of ``cfg``'s ray
    tile, each tile's loss backpropagated as it is computed (the grads
    accumulate in the scene's leaf tensors; one tile's graph lives at a
    time) -> the loss, detached."""
    tile = tile_size(cfg, o.shape[0], o.device)
    total = torch.zeros((), dtype=torch.float32, device=o.device)
    for s in range(0, o.shape[0], tile):
        sl = slice(s, s + tile)
        loss = torch.sum((render_rays(scene, o[sl], d[sl], d_raw[sl], cfg) - target[sl]) ** 2) / denom
        if loss.requires_grad:  # else no leaf reaches the image
            loss.backward()
        total = total + loss.detach()
    return total


def loss_and_param_grads_sharded(scene, target_flat, cfg, mesh: Mesh,
                                 params: Sequence[str] = ("spheres", "lights"), axis: str = "dp"):
    """``grad.loss_and_param_grads`` with the rays sharded over ``axis``:
    each rank's loss is its share's squared error over the *global* pixel
    count (padding rays included, as in JAX), backpropagated, and the loss
    and every gradient are all-reduced (SUM) over the axis -> (loss, grads),
    the same on every rank of the group."""
    from ..grad import from_leaves, leaves, merge_params, split_float_params

    k, group = mesh.shape[axis], mesh.groups[axis]
    o, d, d_raw = primary_rays(cfg.Width, cfg.Height, device=scene.device)
    o, d, d_raw, target = (local_rows(_pad_to(x, k)[0], mesh, axis) for x in (o, d, d_raw, target_flat))
    diff = split_float_params(scene, params)
    tensors = [x.detach().clone().requires_grad_(True) for x in leaves(diff)]
    loss = tiled_loss_backward(merge_params(scene, from_leaves(diff, tensors)), cfg, o, d, d_raw, target,
                               float(target.numel() * k))
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in tensors]
    for g in grads + [loss]:
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    return loss, from_leaves(diff, grads)


def make_train_step(cfg, mesh: Mesh, params: Sequence[str] = ("spheres", "lights"),
                    axis: str = "dp", lr: float = 0.1):
    """The distributed inverse-rendering step: ``step(scene, target_flat)
    -> (loss, new_scene)``, ``target_flat`` the (H*W, 3) target image;
    ``loss_and_param_grads_sharded`` then ``grad.sgd_step``."""
    from ..grad import sgd_step

    def step(scene, target_flat):
        loss, grads = loss_and_param_grads_sharded(scene, target_flat, cfg, mesh, params, axis)
        return loss, sgd_step(scene, grads, lr)

    return step


def replicate_scene(scene, mesh: Mesh, axis: str = "dp"):
    """Every scene tensor broadcast from the axis's first rank over its
    group (every rank built a scene of the same structure and shapes)."""
    if scene.shard is not None:
        raise ValueError("replicate_scene: a leaf-sharded scene holds one shard per rank")
    group = mesh.groups[axis]
    src = dist.get_global_rank(group, 0)

    def bcast(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{f.name: bcast(getattr(obj, f.name))
                                               for f in dataclasses.fields(obj) if f.init})
        if isinstance(obj, torch.Tensor):
            out = obj.detach().clone().contiguous()
            dist.broadcast(out, src=src, group=group)
            return out
        return obj

    return bcast(scene)
