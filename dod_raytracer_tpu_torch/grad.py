"""Inverse-rendering utilities: losses, parameter gradients, update steps.

Counterpart of ``dod_raytracer_tpu.grad``, with torch autograd in place of
``jax.grad``.  The whole pipeline is differentiable: pixel loss ->
gradients w.r.t. vertex positions, sphere parameters, material albedo and
light intensity, because

* every intersection picks its winner without gradient (an argmin, the kd
  walk or a brute-force kernel) and recomputes the winner's hit
  analytically, with gradient, from the gathered primitive; and
* shadow visibility is a step function computed without gradient.

No kernel has a backward: the backward launches no traversal kernel
(under ``remat_bounces`` its recompute of a bounce launches the
families' closest-hit kernel again, which keeps no state).

The parameters are the scene's own dataclasses: ``split_float_params``
picks families ('spheres', 'lights', ...) or dotted leaves
('spheres.color', 'triangles.verts'), with None for integer leaves, and
``merge_params`` puts them back with ``dataclasses.replace``.  A welded
mesh's joined vertex positions, 'triangles.positions', are a leaf too:
its corners and smooth normals derive from them in the graph
(``mesh.derive``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .accel.kdtree import follow_vertices
from .camera import primary_rays
from .mesh import derive
from .render import render_rays


def render_for_grad(scene, cfg, width=None, height=None) -> torch.Tensor:
    """Un-tiled differentiable render (H, W, 3) on the scene's device: the
    primary rays in pixel order through ``render_rays``."""
    w = width or cfg.Width
    h = height or cfg.Height
    o, d, d_raw = primary_rays(w, h, device=scene.device)
    return render_rays(scene, o, d, d_raw, cfg).reshape(h, w, 3)


def mse_loss(scene, target, cfg, width=None, height=None) -> torch.Tensor:
    img = render_for_grad(scene, cfg, width, height)
    return torch.mean((img - target) ** 2)


def _map(fn, *trees):
    """``fn`` over the leaves of parameter trees of one structure: a
    tensor, None, or a dataclass whose tensor (or None) fields are leaves
    and whose other fields ride along from the first tree."""
    first = trees[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)
            if getattr(first, f.name) is None or isinstance(getattr(first, f.name), torch.Tensor)
            or dataclasses.is_dataclass(getattr(first, f.name))})
    return fn(*trees)


def leaves(tree) -> list:
    """The tensors of a parameter tree (or of a dict of them), in field
    order; None leaves are skipped."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in leaves(getattr(tree, f.name))]
    return [tree] if isinstance(tree, torch.Tensor) else []


def from_leaves(diff: dict, tensors) -> dict:
    """``diff``'s structure with its tensors replaced, in ``leaves`` order."""
    it = iter(tensors)
    return {p: _map(lambda x: None if x is None else next(it), sub) for p, sub in diff.items()}


def _keep(x):
    return x if isinstance(x, torch.Tensor) and x.is_floating_point() else None


def split_float_params(scene, params: Sequence[str]) -> dict:
    """Extract the selected scene parameters as a grad-ready dict.

    Entries are either a whole family ('spheres', 'lights', ...) or a
    dotted leaf path ('spheres.color', 'lights.intensity',
    'triangles.verts').  Integer leaves are None.
    """
    diff = {}
    for p in params:
        if "." in p:
            fam, field = p.split(".", 1)
            diff[p] = _keep(getattr(getattr(scene, fam), field))
        else:
            diff[p] = _map(_keep, getattr(scene, p))
    return diff


def merge_params(scene, diff: dict):
    """Inverse of split_float_params: None leaves keep the scene's value.
    New 'triangles.positions' derive the corners and normals
    (``mesh.derive``, in the graph).  The kd tree stays the scene's: after
    an update that moves the vertices, ``follow_moves`` brings it up to
    date."""
    updates: dict = {}
    for p, sub in diff.items():
        if "." in p:
            fam, field = p.split(".", 1)
            cur = updates.get(fam, getattr(scene, fam))
            if sub is not None:
                cur = dataclasses.replace(cur, **{field: sub})
            updates[fam] = cur
        else:
            assert p not in updates, f"mixing '{p}' with dotted paths of the same family"
            updates[p] = _map(lambda o, s: o if s is None else s, getattr(scene, p), sub)
    out = dataclasses.replace(scene, **updates)
    tris = out.triangles
    if tris.positions is not None and tris.positions is not scene.triangles.positions:
        verts, normals = derive(tris.positions, tris.faces)
        out = dataclasses.replace(out, triangles=dataclasses.replace(tris, verts=verts, normals=normals))
    return out


def follow_moves(before, after):
    """``after``, a scene whose vertices an update may have moved from
    ``before``'s (an optimizer's step, ``sgd_step``, a restored
    checkpoint), with its kd tree following them
    (``accel.kdtree.follow_vertices``: the leaf blocks repacked, every
    lane filed again where a triangle left its lane's filing box).  The kd upkeep
    of a step, once, after its update; an update that kept the vertex
    tensor does none."""
    if after.kd is None or after.kd.block_tris is None or after.triangles.verts is before.triangles.verts:
        return after
    return dataclasses.replace(after, kd=follow_vertices(after.kd, before.triangles.verts, after.triangles.verts))


def loss_and_param_grads(scene, target, cfg, params: Sequence[str] = ("spheres", "lights")):
    """Value and gradients of the pixel MSE w.r.t. selected scene subtrees.

    ``params`` selects top-level Scene fields ('spheres', 'planes',
    'cylinders', 'triangles', 'mesh_colors', 'lights') or dotted leaves;
    everything else is constant.  -> (loss, grads in ``split_float_params``'
    structure, None for integer leaves).
    """
    diff = split_float_params(scene, params)
    tensors = [x.detach().clone().requires_grad_(True) for x in leaves(diff)]
    loss = mse_loss(merge_params(scene, from_leaves(diff, tensors)), target, cfg)
    if loss.requires_grad:  # else no selected parameter reaches the image
        loss.backward()
    # zeros where the loss did not reach a leaf, as jax.grad gives
    return loss.detach(), from_leaves(diff, [torch.zeros_like(x) if x.grad is None else x.grad for x in tensors])


def sgd_step(scene, grads: dict, lr: float):
    """Apply a plain gradient step to the selected subtrees (None leaves in
    ``grads`` are left untouched)."""
    stepped = {}
    for name, g in grads.items():
        if "." in name:
            fam, field = name.split(".", 1)
            cur = getattr(getattr(scene, fam), field)
        else:
            cur = getattr(scene, name)
        stepped[name] = _map(lambda gl, p: None if gl is None else (p - lr * gl).detach(), g, cur)
    return follow_moves(scene, merge_params(scene, stepped))


def finite_difference(f: Callable[[Any], torch.Tensor], x, eps: float = 1e-3) -> np.ndarray:
    """Central finite differences of a scalar function at every element of
    x (a test utility for the gradients): f takes a float32 tensor on x's
    device (the CPU for a numpy x)."""
    device = x.device if isinstance(x, torch.Tensor) else "cpu"
    x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).astype(np.float64)
    g = np.zeros_like(x)
    for i in np.ndindex(x.shape):
        xp = x.copy()
        xm = x.copy()
        xp[i] += eps
        xm[i] -= eps
        fp = float(f(torch.tensor(xp, dtype=torch.float32, device=device)))
        fm = float(f(torch.tensor(xm, dtype=torch.float32, device=device)))
        g[i] = (fp - fm) / (2 * eps)
    return g
