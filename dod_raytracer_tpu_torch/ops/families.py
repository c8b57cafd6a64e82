"""Any-hit of a shadow wavefront against the sphere, plane and cylinder
families: the wrapper of ``csrc/families_any.cu``.

It replaces no TPU kernel: the JAX package computes these tests in XLA
(``dod_raytracer_tpu/intersect.py`` ``occluded_families``).  The kernel is
built at first use with plain ``nvcc`` and bound with ``ctypes``
(``ops._cuda``).  ``occluded_any`` launches it for CUDA tensors, or
raises; for CPU tensors it runs the plain version ``occluded_plain``, the
torch composition of ``ops/sphere.py``, ``ops/plane.py`` and
``ops/cylinder.py``, whose bits the kernel gives on the card.  Every
launch adds one to ``launches["any"]``; every call counts its lanes under
the tracer's ``families.lanes.any``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import _cuda
from . import cylinder as cyl_ops
from . import plane as plane_ops
from . import sphere as sphere_ops

NAME = "families_any"

launches = {"any": 0}


def reset_launches() -> None:
    launches["any"] = 0


def _fn():
    return _cuda.library(NAME, "dod_families_any",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def occluded_plain(scene, o, d, t_max, eps) -> torch.Tensor:
    """(N,) bool: does a sphere, plane or cylinder block each ray strictly
    before its t_max?  The kernel's plain version."""
    blocked = sphere_ops.occluded_spheres(scene.spheres, o, d, t_max)
    blocked = blocked | plane_ops.occluded_planes(scene.planes, o, d, t_max, eps)
    return blocked | cyl_ops.occluded_cylinders(scene.cylinders, o, d, t_max, eps, n_valid=scene.n_cylinders)


def _tables(scene, dev) -> list:
    """The family tables the kernel reads, contiguous and checked:
    sphere centres and radii, plane points and normals, cylinder bases,
    axes, radii and heights."""
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    S, P, C = sp.center.shape[0], pl.point.shape[0], cy.base.shape[0]
    tables = []
    for name, t, shape in (("spheres.center", sp.center, (S, 3)), ("spheres.radius", sp.radius, (S,)),
                           ("planes.point", pl.point, (P, 3)), ("planes.normal", pl.normal, (P, 3)),
                           ("cylinders.base", cy.base, (C, 3)), ("cylinders.axis", cy.axis, (C, 3)),
                           ("cylinders.radius", cy.radius, (C,)), ("cylinders.height", cy.height, (C,))):
        t = t.detach().contiguous()
        _cuda.check(name, t, torch.float32, shape, dev)
        tables.append(t)
    return tables


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
    _cuda.check_count(n)
    o, d, t_max = (x.detach().contiguous() for x in (o, d, t_max))
    _cuda.check("o", o, torch.float32, (n, 3), dev)
    _cuda.check("d", d, torch.float32, (n, 3), dev)
    _cuda.check("t_max", t_max, torch.float32, (n,), dev)
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
