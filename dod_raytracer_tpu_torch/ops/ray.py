"""Hit records as dataclasses of tensors.

Counterpart of ``dod_raytracer_tpu.ops.ray`` (the reference's
``HitRecord``, ``hitrecord.h:4-10``): one wavefront of ``(N,)`` rays;
``t == +inf`` encodes a miss.
"""

from __future__ import annotations

import dataclasses

import torch

INF = float("inf")


@dataclasses.dataclass
class FamilyHit:
    """Per-family closest-hit candidate: t == +inf encodes a miss."""

    t: torch.Tensor  # (N,) f32, +inf on miss
    normal: torch.Tensor  # (N, 3) f32 (garbage on miss)
    color: torch.Tensor  # (N, 3) f32 (garbage on miss)


@dataclasses.dataclass
class Hit:
    """Fused scene hit record (HitRecord equivalent, hitrecord.h:4-10)."""

    t: torch.Tensor  # (N,) f32, +inf on miss
    point: torch.Tensor  # (N, 3) f32
    normal: torch.Tensor  # (N, 3) f32
    color: torch.Tensor  # (N, 3) f32
    mask: torch.Tensor  # (N,) bool — True where something was hit


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, the rows of a primitive table picked by each ray's
    winner, by ``index_select``.  Its backward adds the rays' grads with
    atomics; advanced indexing's backward sorts the indices and sums each
    index's rows serially, which is slow where most rays share a row (a
    table of a few primitives, or row 0, the clamped index of every ray
    that misses the mesh)."""
    return table.index_select(0, idx)


def miss_like(n: int, device) -> FamilyHit:
    return FamilyHit(
        t=torch.full((n,), INF, dtype=torch.float32, device=device),
        normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
        color=torch.zeros((n, 3), dtype=torch.float32, device=device),
    )


def closer(a: FamilyHit, b: FamilyHit) -> FamilyHit:
    """Fuse two family candidates with the reference's chaining protocol:
    the *later* family wins only on a strictly smaller t (main.cpp:314-321)."""
    take_b = b.t < a.t
    return FamilyHit(
        t=torch.where(take_b, b.t, a.t),
        normal=torch.where(take_b[:, None], b.normal, a.normal),
        color=torch.where(take_b[:, None], b.color, a.color),
    )
