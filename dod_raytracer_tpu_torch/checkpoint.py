"""Checkpoint / resume: scene-parameter and optimizer checkpoints for the
inverse-rendering loop, and ``TiledRenderJob``, a render that resumes
tile by tile.

Counterpart of ``dod_raytracer_tpu.checkpoint``.  Parameter files keep
its ``.npz`` layout: a ``__meta__`` JSON entry ({"step": ...}) and
one entry per tensor leaf, keyed by its path as JAX's
``tree_flatten_with_path`` spells it: ``['params']/['spheres']/.color``
for a dict key then a dataclass field, ``[0]`` for an integer key.  A
parameter file written by either package therefore restores in the
other.  The optimizer state is the torch optimizer's ``state_dict``
tensors under ``['opt_state']/['state']/[i]/['exp_avg']`` and so on;
the JAX package cannot read those (its optax state has another
structure).  A tiled job's directory has the JAX package's layout, so
either package resumes a job the other began.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .grad import follow_moves, merge_params, split_float_params


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: tensor} over dicts, dataclasses and tensors; None and
    non-tensor leaves are dropped, as JAX drops None."""
    out = {}
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", v) for k, v in sorted(tree.items(), key=lambda kv: str(kv[0]))]
    elif dataclasses.is_dataclass(tree):
        items = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, torch.Tensor):
        return {prefix: tree}
    else:
        return out
    for key, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten(template, flat: dict, prefix: str = ""):
    """``template`` with each tensor leaf replaced by ``flat[path]``, on the
    leaf's device and in its dtype."""
    def key_of(key):
        return f"{prefix}/{key}" if prefix else key

    if isinstance(template, dict):
        return {k: _unflatten(v, flat, key_of(f"[{k!r}]")) for k, v in template.items()}
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), flat, key_of(f".{f.name}"))
            for f in dataclasses.fields(template)})
    if isinstance(template, torch.Tensor):
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: the file holds shape {arr.shape}, the template {tuple(template.shape)}")
        return torch.from_numpy(np.array(arr, copy=True)).to(device=template.device, dtype=template.dtype)
    return template


def save_pytree(path: str, tree, step: Optional[int] = None) -> None:
    """Save a tree of tensors (dicts and dataclasses of tensors)."""
    flat = {k: v.detach().cpu().numpy() for k, v in _flatten_with_paths(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, __meta__=json.dumps({"step": step}), **flat)


def restore_pytree(path: str, template):
    """Restore into the structure of ``template`` (shapes must match) ->
    (tree, step)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in _flatten_with_paths(template)}
        meta = json.loads(str(z["__meta__"]))
    return _unflatten(template, flat), meta.get("step")


def save_scene_params(path: str, scene, params=("spheres", "lights"), step=None,
                      opt_state=None) -> None:
    """The selected parameters (``grad.split_float_params``) and, optionally,
    an optimizer ``state_dict()``; its param_groups are not saved (the
    restoring optimizer brings its own)."""
    payload = {"params": split_float_params(scene, list(params))}
    if opt_state is not None:
        payload["opt_state"] = {"state": opt_state["state"]}
    save_pytree(path, payload, step=step)


def restore_scene_params(path: str, scene, params=("spheres", "lights"),
                         opt_state_template=None):
    """-> (scene with the saved parameters merged in, the optimizer
    state_dict or None, step).  ``opt_state_template`` is the state_dict of
    an optimizer over the same parameters, whose state is filled
    (``train.make_optimizer`` fills it at once); its param_groups are kept."""
    template = {"params": split_float_params(scene, list(params))}
    if opt_state_template is not None:
        template["opt_state"] = {"state": opt_state_template["state"]}
    payload, step = restore_pytree(path, template)
    opt_state = None
    if opt_state_template is not None:
        opt_state = dict(opt_state_template, state=payload["opt_state"]["state"])
    return follow_moves(scene, merge_params(scene, payload["params"])), opt_state, step


class TiledRenderJob:
    """Resumable full-frame render: one ``.npy`` per finished ray tile.

    The JAX package's job layout (``dod_raytracer_tpu/checkpoint.py:78-138``):
    the frame's primary rays in row-major order, padded to a whole number
    of tiles with rays o = 0, d = (0, 0, 1); ``tile or cfg.ray_tile`` rays a
    tile (``ray_tile=0``: ``render._auto_ray_tile`` on ``device``); tile i
    saved as ``tile_{i:06d}.npy``, its (tile, 3) float32 colors, written to
    a temporary file and then renamed, so a crash never leaves a partial
    tile.  A restarted job renders only the tiles not yet saved; a job
    split over hosts gives each ``owner`` of ``num_owners`` the tiles i
    with i % num_owners == owner.  Rendering the same scene and tile,
    either package resumes the other's directory.
    """

    def __init__(self, workdir: str, cfg, tile: Optional[int] = None,
                 owner: int = 0, num_owners: int = 1, device="cuda"):
        from .render import _auto_ray_tile

        self.workdir = workdir
        self.cfg = cfg
        self.device = torch.device(device)
        n = cfg.Width * cfg.Height
        self.tile = tile or cfg.ray_tile or _auto_ray_tile(n, self.device)
        self.owner = owner
        self.num_owners = num_owners
        self.num_tiles = -(-n // self.tile)
        self.write_seconds = 0.0  # spent saving tiles, over this job's runs
        os.makedirs(workdir, exist_ok=True)

    def _tile_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"tile_{i:06d}.npy")

    def done_tiles(self):
        return [i for i in range(self.num_tiles) if os.path.exists(self._tile_path(i))]

    def run(self, scene) -> Optional[np.ndarray]:
        """Render every owned tile not yet saved, on ``self.device`` (the
        scene's device), without gradient; -> the full (H, W, 3) frame once
        every tile of every owner exists, else None."""
        from .camera import primary_rays
        from .render import render_rays

        if scene.device.type != self.device.type:
            raise ValueError(f"scene is on {scene.device}, the job renders on {self.device}")
        o, d, d_raw = primary_rays(self.cfg.Width, self.cfg.Height, device=scene.device)
        pad = self.num_tiles * self.tile - o.shape[0]
        if pad:
            fill = torch.tensor([[0.0, 0.0, 1.0]], device=scene.device).expand(pad, 3)
            o = torch.cat([o, torch.zeros((pad, 3), device=scene.device)])
            d = torch.cat([d, fill])
            d_raw = torch.cat([d_raw, fill])
        for i in range(self.num_tiles):
            if i % self.num_owners != self.owner:
                continue
            path = self._tile_path(i)
            if os.path.exists(path):
                continue
            sl = slice(i * self.tile, (i + 1) * self.tile)
            with torch.no_grad():
                colors = render_rays(scene, o[sl].contiguous(), d[sl].contiguous(), d_raw[sl].contiguous(),
                                     self.cfg).cpu().numpy()
            t0 = time.perf_counter()
            tmp = path + ".tmp.npy"
            np.save(tmp, colors.astype(np.float32))
            os.replace(tmp, path)
            self.write_seconds += time.perf_counter() - t0
        return self.assemble()

    def assemble(self) -> Optional[np.ndarray]:
        """The full (H, W, 3) float32 frame from the saved tiles, or None
        while a tile is missing."""
        if len(self.done_tiles()) < self.num_tiles:
            return None
        n = self.cfg.Width * self.cfg.Height
        out = np.empty((self.num_tiles * self.tile, 3), np.float32)
        for i in range(self.num_tiles):
            out[i * self.tile:(i + 1) * self.tile] = np.load(self._tile_path(i))
        return out[:n].reshape(self.cfg.Height, self.cfg.Width, 3)
