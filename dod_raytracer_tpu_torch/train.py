"""Inverse-rendering training loop (Adam) with checkpoint/resume.

Counterpart of ``dod_raytracer_tpu.train``, with ``torch.optim.Adam`` in
place of ``optax.adam`` (the same defaults: betas 0.9 and 0.999, eps
1e-8, and the same update).  The optimizer owns one leaf tensor per
parameter of ``grad.split_float_params``; ``make_optimizer`` makes its
state at once (zero moments, step 0), as optax's ``init`` does, so that a
checkpoint can be restored into it before the first step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence

import torch

from .checkpoint import restore_scene_params, save_scene_params
from .grad import follow_moves, from_leaves, leaves, merge_params, mse_loss, split_float_params
from .utils.profiling import span


@dataclasses.dataclass
class TrainState:
    scene: object
    opt_state: object  # the torch optimizer of make_optimizer
    step: int = 0


def make_optimizer(lr: float = 0.05) -> Callable:
    """-> init(diff): a torch Adam over fresh leaf copies of the tensors of
    split parameters ``diff``, with its state made."""
    def init(diff: dict) -> torch.optim.Adam:
        params = [x.detach().clone().requires_grad_(True) for x in leaves(diff)]
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for p in params:
            opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
        return opt
    return init


def make_update_fn(cfg, params: Sequence[str], loss_fn: Optional[Callable] = None):
    """-> update(scene, opt_state, target) -> (loss, scene, opt_state): one
    Adam step of the parameters ``params`` on the loss (the pixel MSE by
    default).  ``opt_state`` is the optimizer of ``make_optimizer``; the
    scene's current values are copied into its leaves first, so any scene
    of the same structure may come in."""
    loss_fn = loss_fn or (lambda scene, target: mse_loss(scene, target, cfg))

    def update(scene, opt_state, target):
        with span("train.forward"):
            diff = split_float_params(scene, params)
            tensors = opt_state.param_groups[0]["params"]
            with torch.no_grad():
                for p, x in zip(tensors, leaves(diff)):
                    p.copy_(x)
            opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(merge_params(scene, from_leaves(diff, tensors)), target)
        with span("train.backward"):
            loss.backward()
            for p in tensors:  # a parameter the loss did not reach: a zero gradient, as in optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with span("train.optim"):
            opt_state.step()
            stepped = from_leaves(diff, [p.detach().clone() for p in tensors])
            return loss.detach(), follow_moves(scene, merge_params(scene, stepped)), opt_state

    return update


def fit(scene, target, cfg, params: Sequence[str] = ("spheres", "lights"),
        steps: int = 100, lr: float = 0.05,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 25,
        log_every: int = 10, verbose: bool = True):
    """Run inverse rendering; returns (scene, losses).  With
    ``checkpoint_path``, resumes from the file when it exists and saves
    the parameters and the optimizer state every ``checkpoint_every``
    steps."""
    opt = make_optimizer(lr)(split_float_params(scene, params))
    start_step = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        scene, opt_state, start_step = restore_scene_params(
            checkpoint_path, scene, params=params, opt_state_template=opt.state_dict())
        opt.load_state_dict(opt_state)
        start_step = start_step or 0

    update = make_update_fn(cfg, params)
    losses = []
    for step in range(start_step, steps):
        loss, scene, opt = update(scene, opt, target)
        losses.append(loss)
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"step {step}: loss {float(loss):.6e}")
        if checkpoint_path is not None and (step + 1) % checkpoint_every == 0:
            save_scene_params(checkpoint_path, scene, params=params,
                              step=step + 1, opt_state=opt.state_dict())
    return scene, [float(v) for v in (torch.stack(losses).cpu() if losses else [])]
