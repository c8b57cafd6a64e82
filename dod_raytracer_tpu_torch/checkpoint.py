"""Scene-parameter and optimizer checkpoints for the inverse-rendering loop.

Counterpart of the parameter half of ``dod_raytracer_tpu.checkpoint``,
with its ``.npz`` layout: a ``__meta__`` JSON entry ({"step": ...}) and
one entry per tensor leaf, keyed by its path as JAX's
``tree_flatten_with_path`` spells it: ``['params']/['spheres']/.color``
for a dict key then a dataclass field, ``[0]`` for an integer key.  A
parameter file written by either package therefore restores in the
other.  The optimizer state is the torch optimizer's ``state_dict``
tensors under ``['opt_state']/['state']/[i]/['exp_avg']`` and so on;
the JAX package cannot read those (its optax state has another
structure).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .grad import merge_params, split_float_params


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
    return merge_params(scene, payload["params"]), opt_state, step
