"""The plain reference of the teapot fit: Adam steps on the reference's image.

The fitted parameters (sphere colours, the mesh colour, light intensities)
change no ray's path, so the reference traces the frame's geometry once
(``render.trace``) and renders every step's image with ``render.shade``
from it.  The loss is the mean squared error over the H x W x 3 image
against a target rendered the same way from the true parameters; the
gradients are torch autograd's of that; the update is Adam written out
(betas 0.9 and 0.999, eps 1e-8), in the reference's dtype.
"""

from __future__ import annotations

import torch

from . import render

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def fit(s, terms, target, start: list, lr: float, steps: int, share: float = 1.0):
    """-> (losses [steps], first gradients [leaf], parameter change after
    ``steps`` [leaf]); ``start`` holds the sphere colours, the mesh colour
    and the light intensities, the leaves in that order.  ``share`` < 1
    takes the loss over that leading share of the pixels only (a fault,
    for the control's readings)."""
    n = int(round(share * target.shape[0]))
    fixed = s.colors[s.off_plane:s.off_mesh]
    params = [x.detach().clone().to(s.dtype) for x in start]
    m = [torch.zeros_like(x) for x in params]
    v = [torch.zeros_like(x) for x in params]
    losses, first = [], None
    for k in range(1, steps + 1):
        leaves = [x.detach().requires_grad_(True) for x in params]
        img = render.shade(terms, torch.cat([leaves[0], fixed, leaves[1]]), leaves[2])
        loss = torch.mean((img[:n] - target[:n]) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first is None:
            first = [g.detach().clone() for g in grads]
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = BETA1 * m[i] + (1 - BETA1) * g
                v[i] = BETA2 * v[i] + (1 - BETA2) * g * g
                mhat = m[i] / (1 - BETA1 ** k)
                vhat = v[i] / (1 - BETA2 ** k)
                params[i] = params[i] - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
    change = [p - x.to(s.dtype) for p, x in zip(params, start)]
    return losses, first, change
