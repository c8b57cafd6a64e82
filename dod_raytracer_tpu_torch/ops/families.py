"""The sphere, plane and cylinder families on the card: the wrappers of
``csrc/families_any.cu`` (the shadow rays' any-hit) and
``csrc/families_closest.cu`` (the closest hit).

Neither replaces a TPU kernel: the JAX package computes these tests in
XLA (``dod_raytracer_tpu/intersect.py`` ``closest_families`` and
``occluded_families``).  The kernels are built at first use with plain
``nvcc`` and bound with ``ctypes`` (``ops._cuda``).  ``occluded_any`` and
``closest`` launch them for CUDA tensors, or raise; for CPU tensors they
run the plain versions ``occluded_plain`` and ``closest_plain``, the torch
compositions of ``ops/sphere.py``, ``ops/plane.py`` and
``ops/cylinder.py``, whose bits the kernels give on the card.  Every
launch adds one to ``launches["any"]`` or ``launches["closest"]``; every
call counts its lanes under the tracer's ``families.lanes.any`` or
``families.lanes.closest``.

The closest hit's winner is one int32 a ray: -1 for a miss,
else ``row << 4 | kind << 2 | family`` with family 0 sphere, 1 plane,
2 cylinder and kind the cylinder's candidate (0 body, 1 disc at its
base, 2 disc at its top; 0 for the others).  What ``closest`` returns
with gradient follows from which inputs require it (``closest``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import _cuda
from . import cylinder as cyl_ops
from . import plane as plane_ops
from . import sphere as sphere_ops
from .ray import FamilyHit, closer, take

NAME = "families_any"
NAME_CLOSEST = "families_closest"
MAX_ROWS = 1 << 27  # the rows a winner code holds

launches = {"any": 0, "closest": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _fn():
    return _cuda.library(NAME, "dod_families_any",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def _fn_closest():
    return _cuda.library(NAME_CLOSEST, "dod_families_closest",
                         [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                                         ctypes.c_void_p])


def occluded_plain(scene, o, d, t_max, eps) -> torch.Tensor:
    """(N,) bool: does a sphere, plane or cylinder block each ray strictly
    before its t_max?  The kernel's plain version."""
    blocked = sphere_ops.occluded_spheres(scene.spheres, o, d, t_max)
    blocked = blocked | plane_ops.occluded_planes(scene.planes, o, d, t_max, eps)
    return blocked | cyl_ops.occluded_cylinders(scene.cylinders, o, d, t_max, eps, n_valid=scene.n_cylinders)


def _tables(scene, dev, colors: bool = False) -> list:
    """The family tables a kernel reads, contiguous and checked: sphere
    centres and radii, plane points and normals, cylinder bases, axes,
    radii and heights; with ``colors``, each family's colours after its
    other tables."""
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    S, P, C = sp.center.shape[0], pl.point.shape[0], cy.base.shape[0]
    named = [("spheres.center", sp.center, (S, 3)), ("spheres.radius", sp.radius, (S,)),
             ("spheres.color", sp.color, (S, 3)),
             ("planes.point", pl.point, (P, 3)), ("planes.normal", pl.normal, (P, 3)),
             ("planes.color", pl.color, (P, 3)),
             ("cylinders.base", cy.base, (C, 3)), ("cylinders.axis", cy.axis, (C, 3)),
             ("cylinders.radius", cy.radius, (C,)), ("cylinders.height", cy.height, (C,)),
             ("cylinders.color", cy.color, (C, 3))]
    tables = []
    for name, t, shape in named:
        if colors or not name.endswith(".color"):
            t = t.detach().contiguous()
            _cuda.check(name, t, torch.float32, shape, dev)
            tables.append(t)
    return tables


def _rays(o, d, t_max):
    """The rays a kernel reads, contiguous and checked -> (n, o, d, t_max)."""
    n, dev = o.shape[0], o.device
    _cuda.check_count(n)
    o, d, t_max = (x.detach().contiguous() for x in (o, d, t_max))
    _cuda.check("o", o, torch.float32, (n, 3), dev)
    _cuda.check("d", d, torch.float32, (n, 3), dev)
    _cuda.check("t_max", t_max, torch.float32, (n,), dev)
    return n, o, d, t_max


def occluded_any(scene, o, d, t_max, eps) -> torch.Tensor:
    """(N,) bool any-hit of rays ``o``, ``d`` (N, 3) before ``t_max`` (N,)
    against the scene's spheres, planes and the first ``scene.n_cylinders``
    cylinders: ``occluded_plain``'s bits.

    CUDA tensors launch the kernel; float32 tables and rays on the rays'
    device are required (``ValueError``, ``TypeError`` for a dtype)."""
    n = o.shape[0]
    count("families.lanes.any", n)
    if o.device.type == "cpu":
        return occluded_plain(scene, o, d, t_max, eps)
    if o.device.type != "cuda":
        raise ValueError(f"occluded_any runs on cuda or cpu tensors, got {o.device}")
    dev = o.device
    n, o, d, t_max = _rays(o, d, t_max)
    tables = _tables(scene, dev)
    n_cyl = min(scene.n_cylinders, tables[4].shape[0])
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
                 n, tables[0].shape[0], tables[2].shape[0], n_cyl, float(eps), _cuda.stream_of(dev))
    _cuda.raise_on(err, "families_any")
    launches["any"] += 1
    return out


# ---- the closest hit (csrc/families_closest.cu) ----

def _decode(winner):
    """-> (family, row, kind, a spread row index) of winner codes: family
    3 and row -1 on a miss.  Each family's rows (``_rows``) point the rays
    that family did not win at rows spread over its table: they take a
    zero gradient, and spread, the backward's atomic adds of those zeros do
    not queue on one row (``ray.take``)."""
    return winner & 3, (winner >> 4).long(), (winner >> 2) & 3, torch.arange(winner.shape[0], device=winner.device)


def _rows(family, row, spread, f: int, table):
    """Each ray's row of family ``f``'s ``table`` (see ``_decode``)."""
    return torch.where(family == f, row, spread % table.shape[0])


@torch.no_grad()
def winner_plain(scene, o, d, t_max, eps):
    """(N,) int32 winner codes: the closest of the sphere, plane and
    cylinder hits strictly before ``t_max`` (N,), as the reference's
    chain picks it (sphere -> plane -> cylinder, each family clipped at
    the running closest t and winning only on a strictly smaller one, the
    first of equal candidates within a family).  The first half of the
    kernel's plain version."""
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    si, s_hit = sphere_ops.sphere_winner(sp, o, d, t_max)
    best = sphere_ops.sphere_hit(sp, o, d, si, s_hit)
    pi, p_hit = plane_ops.plane_winner(pl, o, d, torch.minimum(best.t, t_max), eps)
    best = closer(best, plane_ops.plane_hit(pl, o, d, pi, p_hit))
    cf, c_hit = cyl_ops.cylinder_winner(cy, o, d, torch.minimum(best.t, t_max), eps, n_valid=scene.n_cylinders)
    code = torch.where(c_hit, (cf // 3) * 16 + (cf % 3) * 4 + 2,
                       torch.where(p_hit, pi * 16 + 1, torch.where(s_hit, si * 16, -1)))
    return code.to(torch.int32)


def hit_of(scene, o, d, winner, color_bug: bool) -> FamilyHit:
    """The winners' hits (t +inf on a miss), recomputed in torch from
    their gathered rows, with gradient to every input that requires it:
    each family's second half (``sphere_hit``, ``plane_hit``,
    ``cylinder_hit``) on (N,) and (N, 3) rows, chained as the reference
    chains the families.  The second half of the kernel's plain version."""
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    family, row, kind, spread = _decode(winner)
    best = sphere_ops.sphere_hit(sp, o, d, _rows(family, row, spread, 0, sp.radius), family == 0)
    best = closer(best, plane_ops.plane_hit(pl, o, d, _rows(family, row, spread, 1, pl.point), family == 1))
    return closer(best, cyl_ops.cylinder_hit(cy, o, d, _rows(family, row, spread, 2, cy.radius), kind,
                                             family == 2, color_bug))


def color_of(scene, winner, color_bug: bool) -> torch.Tensor:
    """(N, 3) the winners' colours gathered from the colour tables, with
    gradient to the tables that require it (garbage on a miss)."""
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    family, row, _, spread = _decode(winner)
    color = take(sp.color, _rows(family, row, spread, 0, sp.color))
    color = torch.where((family == 1)[:, None], take(pl.color, _rows(family, row, spread, 1, pl.color)), color)
    cyl = torch.zeros_like(color) if color_bug else take(cy.color, _rows(family, row, spread, 2, cy.color))
    return torch.where((family == 2)[:, None], cyl, color)


def closest_plain(scene, o, d, t_max, eps, color_bug: bool):
    """The kernel's plain version: -> (winner (N,) int32, FamilyHit), the
    winner choice ``winner_plain`` then its recompute ``hit_of``, without
    gradient.  t is +inf on a miss; the normal and colour of a miss are
    garbage (the kernel writes zeros there; nothing reads them)."""
    winner = winner_plain(scene, o, d, t_max, eps)
    with torch.no_grad():
        return winner, hit_of(scene, o, d, winner, color_bug)


def closest_kernel(scene, o, d, t_max, eps, color_bug: bool):
    """One launch of the kernel on CUDA tensors -> (winner (N,) int32,
    FamilyHit) with no gradient: ``closest_plain``'s winner and t, its
    normal and colour where a ray hits, zeros where it misses."""
    dev = o.device
    n, o, d, t_max = _rays(o, d, t_max)
    tables = _tables(scene, dev, colors=True)
    rows = max(t.shape[0] for t in tables)
    if rows > MAX_ROWS:
        raise ValueError(f"a family table of {rows} rows: a winner code holds {MAX_ROWS}")
    n_cyl = min(scene.n_cylinders, tables[6].shape[0])
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    winner = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        fn = _fn_closest()
        with torch.cuda.device(dev):
            err = fn(o.data_ptr(), d.data_ptr(), t_max.data_ptr(), *(x.data_ptr() for x in tables),
                     t.data_ptr(), normal.data_ptr(), color.data_ptr(), winner.data_ptr(),
                     n, tables[0].shape[0], tables[3].shape[0], n_cyl, float(eps), int(bool(color_bug)),
                     _cuda.stream_of(dev))
        _cuda.raise_on(err, "families_closest")
        launches["closest"] += 1
    return winner, FamilyHit(t=t, normal=normal, color=color)


def _requires_grad(*tensors) -> bool:
    return any(x.requires_grad for x in tensors)


def closest(scene, o, d, t_max, eps, color_bug: bool) -> FamilyHit:
    """The closest sphere, plane or cylinder hit of rays ``o``, ``d``
    (N, 3) strictly before ``t_max`` (N,): t (+inf on a miss), normal and
    colour, ``closest_plain``'s bits on every ray that hits.

    CUDA tensors launch the kernel once (float32 tables and rays on the
    rays' device, ``ValueError`` / ``TypeError`` otherwise); CPU tensors
    take the plain version.  With gradients on, what carries them follows
    from which inputs require them:

    - none: the kernel's t, normal and colour;
    - only a colour table: the kernel's t and normal, the colour gathered
      from the tables by the winner (``color_of``);
    - ``o``, ``d`` or any family's geometry: the winner alone is kept and
      its hit recomputed in torch (``hit_of``); the tracer counts those
      rows under ``families.grad.rows``."""
    n = o.shape[0]
    count("families.lanes.closest", n)
    if o.device.type not in ("cuda", "cpu"):
        raise ValueError(f"closest runs on cuda or cpu tensors, got {o.device}")
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    grad = torch.is_grad_enabled()
    geometry = grad and _requires_grad(o, d, sp.center, sp.radius, pl.point, pl.normal, cy.base, cy.axis,
                                       cy.radius, cy.height)
    if o.device.type == "cuda":
        winner, hit = closest_kernel(scene, o, d, t_max, eps, color_bug)
    elif geometry:
        winner = winner_plain(scene, o, d, t_max, eps)
    else:
        winner, hit = closest_plain(scene, o, d, t_max, eps, color_bug)
    if geometry:
        count("families.grad.rows", n)
        return hit_of(scene, o, d, winner, color_bug)
    if grad and _requires_grad(sp.color, pl.color, *(() if color_bug else (cy.color,))):
        return FamilyHit(t=hit.t, normal=hit.normal, color=color_of(scene, winner, color_bug))
    return hit
