"""Primary-ray generation.

Counterpart of ``dod_raytracer_tpu.camera``: the reference's hardcoded
pinhole sweep (``main.cpp:275-279, 294-345``), origin (0, 0, -4.9), and
for pixel (row i, col j) the un-normalized direction

  dir = (-Ratio + j * 2*Ratio/W,  1 - i * 2/H,  1)

The un-normalized direction is kept because the reference feeds the raw
``rayDir`` into the specular term at every bounce (main.cpp:328).
"""

from __future__ import annotations

import torch

from .utils.math import sqrt

ORIGIN = (0.0, 0.0, -4.9)  # main.cpp:275,308


def primary_ray_dirs(width: int, height: int, row0: int = 0, row1: int | None = None,
                     device="cuda") -> torch.Tensor:
    """Un-normalized primary directions for rows [row0, row1), (R*W, 3)
    flattened row-major like the framebuffer (main.cpp:294-299)."""
    if row1 is None:
        row1 = height
    f32 = dict(dtype=torch.float32, device=device)
    ratio = torch.tensor(float(width), **f32) / torch.tensor(float(height), **f32)
    wstep = 2.0 * ratio / width  # main.cpp:278
    hstep = 2.0 / height  # main.cpp:279
    cols = torch.arange(width, **f32)
    rows = torch.arange(row0, row1, **f32)
    x = -ratio + cols * wstep  # main.cpp:276,342
    y = 1.0 - rows * hstep  # main.cpp:276,295,345
    xx, yy = torch.meshgrid(x, y, indexing="xy")  # (R, W)
    d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)  # (R, W, 3)
    return d.reshape(-1, 3)


def primary_rays(width: int, height: int, row0: int = 0, row1: int | None = None,
                 device="cuda"):
    """(origins (N,3), dirs_normalized (N,3), dirs_unnormalized (N,3))."""
    d_raw = primary_ray_dirs(width, height, row0, row1, device)
    norm = sqrt(torch.sum(d_raw * d_raw, dim=-1, keepdim=True))
    d = d_raw / norm  # main.cpp:304 rayNorm
    o = torch.tensor(ORIGIN, dtype=torch.float32, device=device).expand_as(d).contiguous()
    return o, d, d_raw
