"""The plain reference of the teapot shape fit: Adam steps on a welded
mesh's joined vertex positions.

The mesh is held as the reference's import holds it before flattening
(``mesh.cpp:11-14``: joined positions and face indices).  ``welded``
derives its corners by a gather and its smooth normals as the normalised
sum of the adjacent unit face normals, in torch and in autograd.

A step's loss is the mean squared error over the H x W x 3 image, each
channel clamped to [0, 1] as the reference binary shows it, against a
target rendered and clamped the same way from the true positions.  It is computed
in blocks of pixels.  In each block the discrete choices of every bounce
are made without gradient on the current geometry: the closest sphere,
plane or cylinder (an argmin), the closest triangle (``render.Clusters``
over the current corners) and each shadow ray's blocker (``render.occluded``).
The path is then replayed from them with gradient: the chosen family's t,
normal and hit point, the triangle's Moller-Trumbore t and barycentrics
from the welded corners and smooth normals, the reflected ray, and Phong
shading under the fixed shadow bits.  Each block's loss is backpropagated
to the corners and normals at once, and their gradients are carried to the
positions through ``welded`` once a step.  The update is Adam written out
(betas 0.9 and 0.999, eps 1e-8), as ``fit.py``'s, in the reference's dtype.

It imports nothing of the program and takes none of its state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import render
from .fit import ADAM_EPS, BETA1, BETA2

CHUNK = 1 << 17  # pixels traced with gradient at once


def welded(positions, faces):
    """(corners (T, 3, 3), smooth normals (T, 3, 3)) of joined positions
    (V, 3) and faces (T, 3) (int64); degenerate faces add nothing."""
    tri = positions[faces]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    fn = _unit(fn)
    vn = torch.zeros_like(positions)
    for k in range(3):
        vn = vn.index_add(0, faces[:, k], fn)
    return tri, _unit(vn)[faces]


def _unit(x):
    n = torch.sqrt(render._dot(x, x))[:, None]
    return torch.where(n > 0, x / torch.where(n > 0, n, 1.0), 0.0)


class ShapeScene(render.RefScene):
    """``render.RefScene`` of the scene's arrays with the welded mesh's
    corners and normals set from ``positions`` (``set_positions``)."""

    def __init__(self, arrays: dict, positions, faces, eps: float, device, dtype=torch.float32):
        self.faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        pos = torch.as_tensor(np.asarray(positions, np.float32), device=device).to(dtype)
        tri, tri_n = welded(pos, self.faces)
        full = dict(arrays, mesh_verts=tri.float().cpu().numpy(), mesh_normals=tri_n.float().cpu().numpy())
        super().__init__(full, eps, device, dtype)
        self.set_positions(pos)

    def set_positions(self, positions):
        """Corners and normals from ``positions`` (kept in its graph), and
        the culling clusters of the corners."""
        self.tri, self.tri_n = welded(positions, self.faces)
        self.acc = render.Clusters(self.tri.detach())


SPHERE, PLANE, BODY, BOTTOM, TOP, TRIANGLE = range(6)  # what a ray hit (BOTTOM, TOP: the cylinder's caps)


@torch.no_grad()
def _choose(s, o, d, tmax):
    """``render.closest_hit``'s choice, without gradient: -> (kind (N,),
    index (N,), t (N,), hit (N,)); kind -1 where nothing is hit."""
    n = o.shape[0]
    t, idx = render._first_min(render._sphere_t(s, o, d))
    t = torch.where(t < tmax, t, render.INF)
    kind = torch.full((n,), SPHERE, dtype=torch.long, device=o.device)
    tp, ip = render._first_min(render._plane_t(s, o, d))
    take = (tp < torch.minimum(t, tmax)) & (tp < t)
    t, kind, idx = torch.where(take, tp, t), torch.where(take, PLANE, kind), torch.where(take, ip, idx)
    if s.n_cyl:
        cl = torch.minimum(t, tmax)
        tc, ic = render._first_min(render._cylinder_t(s, o, d, cl).reshape(n, -1))
        take = (tc < cl) & (tc < t)
        t, kind, idx = torch.where(take, tc, t), torch.where(take, BODY + ic % 3, kind), torch.where(take, ic // 3, idx)
    if s.n_tri:
        tt, ti = s.acc.closest(o, d, torch.minimum(t, tmax))
        take = tt < t
        t, kind, idx = torch.where(take, tt, t), torch.where(take, TRIANGLE, kind), torch.where(take, ti, idx)
    hit = t < tmax
    return torch.where(hit, kind, -1), idx, t, hit


def _replay_kind(s, kind: int, i, o, d, t_found):
    """(t, normal) of rays ``o``, ``d`` that hit primitive ``i`` of ``kind``,
    recomputed with gradient (the reference's formulas at the winner)."""
    dot = render._dot
    if kind == SPHERE:
        c, r = s.sph_c[i], s.sph_r[i]
        L = c - o
        tca = dot(L, d)
        d2 = dot(L, L) - tca * tca
        t = tca - torch.sqrt(r * r - d2)  # the nearer root: both are in front
        delta = o + d * t[:, None] - c
        return t, delta * torch.rsqrt(torch.clamp_min(dot(delta, delta), 1e-30))[:, None]
    if kind == PLANE:
        nrm = s.pl_n[i]
        return dot(s.pl_p[i] - o, nrm) / dot(d, nrm), nrm
    if kind == TRIANGLE:
        tri, nrm = s.tri[i], s.tri_n[i]
        t, u, v = render._mt(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], o, d)
        t = torch.where(torch.isfinite(t), t, t_found)  # a recompute off by a rounding keeps the search's t
        return t, (1.0 - (u + v))[:, None] * nrm[:, 0] + u[:, None] * nrm[:, 1] + v[:, None] * nrm[:, 2]
    ax, base = s.cy_a[i], s.cy_b[i]
    if kind == BODY:
        dp = o - base
        v_rem = d - dot(d, ax)[:, None] * ax
        dp_rem = dp - dot(dp, ax)[:, None] * ax
        a = dot(v_rem, v_rem)
        b = 2.0 * dot(v_rem, dp_rem)
        c = dot(dp_rem, dp_rem) - s.cy_r[i] * s.cy_r[i]
        sq = torch.sqrt(b * b - 4.0 * a * c)
        t_sub, t_add = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
        t = torch.where(t_sub < 0, t_add, torch.where(t_add < 0, t_sub, torch.minimum(t_sub, t_add)))
        p = o + d * t[:, None]
        radial = p - base - ax * dot(p - base, ax)[:, None]
        return t, radial * torch.rsqrt(torch.clamp_min(dot(radial, radial), 1e-30))[:, None]
    center = base + ax * (s.cy_h[i] if kind == TOP else 0.0 * s.cy_h[i])[:, None]
    d_a = dot(d, ax)
    return dot(center - o, ax) / d_a, torch.where((d_a > 0)[:, None], -ax, ax)


def _closest(s, o, d, tmax):
    """The closest hit of ``render.closest_hit``, chosen without gradient
    and replayed with it -> (t, normal, colour index, hit mask)."""
    kind, idx, t_found, hit = _choose(s, o.detach(), d.detach(), tmax)
    t = torch.zeros_like(t_found)
    normal = torch.zeros_like(o)
    for k in range(TRIANGLE + 1):
        rows = torch.nonzero(kind == k)[:, 0]
        if rows.numel():
            tk, nk = _replay_kind(s, k, idx[rows], o[rows], d[rows], t_found[rows])
            t, normal = t.index_put((rows,), tk), normal.index_put((rows,), nk.expand(rows.shape[0], 3))
    offset = torch.tensor([0, s.off_plane, s.off_cyl, s.off_cyl, s.off_cyl, s.off_mesh], device=o.device)
    cidx = torch.where(kind == TRIANGLE, s.off_mesh, idx + offset[kind.clamp_min(0)])
    return t, normal, cidx, hit


def trace(s, d_raw, depth: int):
    """``render.trace`` of one block of rays with the hits' geometry in the
    graph: per bounce (active, colour index, light coefficients)."""
    n = d_raw.shape[0]
    d = d_raw / torch.sqrt(render._dot(d_raw, d_raw))[:, None]
    o = torch.tensor(render.ORIGIN, dtype=s.dtype, device=s.device).expand(n, 3)
    active = torch.ones((n,), dtype=torch.bool, device=s.device)
    lp = s.light_p
    out = []
    for _ in range(depth):
        tmax = torch.where(active, render.INF, -1.0).to(s.dtype)
        t, normal, cidx, mask = _closest(s, o, d, tmax)
        active = active & mask
        p = o + d * torch.where(mask, t, 0.0)[:, None]
        to_light = lp[None] - p[:, None]
        dist_sq = torch.clamp_min(render._dot(to_light, to_light), 1e-30)
        ldir = to_light * torch.rsqrt(dist_sq)[..., None]
        n_dot_l = render._dot(normal[:, None], ldir)
        refl = ldir - 2.0 * n_dot_l[..., None] * normal[:, None]
        spec = torch.clamp_min(render._dot(refl, d_raw[:, None]), 0.0) ** render.SPECULAR_POW
        shade = torch.clamp_min(n_dot_l, 0.0) + spec
        relevant = (shade > 0) & active[:, None]
        dist = torch.sqrt(render._dot(to_light, to_light))
        sdir = to_light / torch.clamp_min(dist, 1e-30)[..., None]
        so = p[:, None] + sdir * render.SHADOW_OFFSET
        smax = torch.where(relevant, dist, -1.0)
        with torch.no_grad():
            blocked = render.occluded(s, so.detach().reshape(-1, 3), sdir.detach().reshape(-1, 3),
                                      smax.detach().reshape(-1)).view(n, -1)
        coef = torch.where(relevant & ~blocked, shade / dist_sq, 0.0)
        out.append((active, cidx, coef))
        d_new = d - 2.0 * render._dot(normal, d)[:, None] * normal
        o_new = p + d_new * s.eps
        o = torch.where(active[:, None], o_new, o)
        d = torch.where(active[:, None], d_new, d)
    return out


def image(s, width: int, height: int, depth: int, pixels=None):
    """(K, 3) linear colours of ``pixels`` (all by default) at the scene's
    current positions, without gradient."""
    if pixels is None:
        pixels = torch.arange(width * height, device=s.device)
    parts = []
    with torch.no_grad():
        for i in range(0, pixels.shape[0], CHUNK):
            d_raw = render.primary_dirs(width, height, pixels[i:i + CHUNK], s.device, s.dtype)
            parts.append(render.shade(trace(s, d_raw, depth), s.colors, s.light_i))
    return torch.cat(parts)


def loss_and_grad(s, positions, target, width: int, height: int, depth: int, share: float = 1.0):
    """(loss, d loss / d positions) at ``positions``, the MSE of the image
    clamped to [0, 1] against ``target`` (H*W, 3, clamped); ``share`` < 1
    takes the loss over that
    leading share of the pixels only (a fault, for the control's
    readings)."""
    n = int(round(share * width * height))
    pos = positions.detach().clone().requires_grad_(True)
    s.set_positions(pos)
    tri, tri_n = s.tri, s.tri_n
    g_tri, g_n = torch.zeros_like(tri), torch.zeros_like(tri_n)
    total = torch.zeros((), dtype=torch.float64, device=s.device)
    pixels = torch.arange(n, device=s.device)
    for i in range(0, n, CHUNK):
        s.tri, s.tri_n = tri.detach().requires_grad_(True), tri_n.detach().requires_grad_(True)
        d_raw = render.primary_dirs(width, height, pixels[i:i + CHUNK], s.device, s.dtype)
        img = render.shade(trace(s, d_raw, depth), s.colors, s.light_i)
        part = torch.sum((torch.clamp(img, 0.0, 1.0) - target[i:min(i + CHUNK, n)]) ** 2) / (3 * n)
        a, b = torch.autograd.grad(part, (s.tri, s.tri_n), allow_unused=True)
        g_tri += 0 if a is None else a
        g_n += 0 if b is None else b
        total += part.detach().double()
    (grad,) = torch.autograd.grad((tri, tri_n), pos, (g_tri, g_n))
    s.tri, s.tri_n = tri.detach(), tri_n.detach()
    return float(total), grad.detach()


def adam_step(positions, grad, m, v, step: int, lr: float):
    """Adam's update at step ``step`` (1-based) from moments ``m``, ``v``
    -> (positions, m, v)."""
    m = BETA1 * m + (1 - BETA1) * grad
    v = BETA2 * v + (1 - BETA2) * grad * grad
    mhat = m / (1 - BETA1 ** step)
    vhat = v / (1 - BETA2 ** step)
    return positions - lr * mhat / (torch.sqrt(vhat) + ADAM_EPS), m, v
