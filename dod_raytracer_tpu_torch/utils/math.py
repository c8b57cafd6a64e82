"""Small vector-math substrate on batched ``(..., 3)`` tensors.

Counterpart of ``dod_raytracer_tpu.utils.math`` (the reference's glm math
and AVX helpers, ``src/utils/avx_utils.h:5-60``): every helper is
elementwise over arbitrary leading batch dims.
"""

from __future__ import annotations

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt.  PyTorch's vectorized CPU sqrt is
    not (some float32 inputs come out one ulp off), while XLA's, numpy's
    and CUDA's are; on the CPU, round through float64 instead."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 dot product -> (...,). avx_utils.h:13-22 equivalent."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched vec3 cross product. avx_utils.h:24-33 equivalent."""
    return torch.linalg.cross(a, b, dim=-1)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """glm::reflect: I - 2*dot(N, I)*N (used at main.cpp:176,332)."""
    return incident - 2.0 * dot(normal, incident)[..., None] * normal


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0 with a finite gradient for x <= 0 (sphere thc,
    sphere.cpp:96-97)."""
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_div(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """a / b where ``valid`` else 0, with no NaN/Inf in forward or backward."""
    denom = torch.where(valid, b, 1.0)
    return torch.where(valid, a, 0.0) / denom
