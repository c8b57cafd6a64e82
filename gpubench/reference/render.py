"""The plain reference: a Whitted ray tracer in plain PyTorch.

It follows the reference binary's semantics (AVassilev98/dod_raytracer,
``src/main.cpp:156-347`` and the family tests of ``sphere.cpp``,
``plane.cpp``, ``cylinder.cpp``, ``triangle.cpp``): a pinhole camera at
(0, 0, -4.9); families tested in the order sphere, plane, cylinder,
triangles, a later family winning only on a strictly smaller t; Phong
shading (ambient 0.2, Lambert, specular power 7 against the raw primary
direction, quadratic falloff) with a shadow ray to each of the lights from
``p + 0.01 * l``; 10 mirror bounces blended with weight 2^-k; a ray ends at
its first miss.

It imports nothing of the program and takes none of its state.  Its
triangle queries run over its own acceleration structure
(``Clusters``: triangles sorted by the Morton code of their centroid,
clusters of 32 and groups of 32 clusters, each with a slightly widened
box), which only culls: every triangle that a ray's box tests let through
is tested with the reference's Moller-Trumbore test (strict, no epsilon).
Everything is computed in ``dtype``; float32 is the configuration's
precision, and a lower one serves as the control.

``trace`` returns, per bounce, what shading needs apart from the colours
and the light intensities: the rays still active, the colour each hit
takes (an index into ``RefScene.colors``) and each light's coefficient
(visible * (diffuse + specular) / distance^2).  ``shade`` blends them with
any colours and intensities, differentiably; a frame is ``shade`` of
``trace`` with the scene's own.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")
ORIGIN = (0.0, 0.0, -4.9)
AMBIENT = 0.2
SPECULAR_POW = 7.0
SHADOW_OFFSET = 0.01
CLUSTER = 32  # triangles a cluster
GROUP = 32  # clusters a group
WIDEN = 1e-3  # boxes widened by this much on every side (the scene spans [-5, 5])
PAIR_CHUNK = 1 << 21  # (ray, box) pairs tested at once


class RefScene:
    """The benchmark's scene arrays (``scenes.inputs.scene_arrays``) as
    ``dtype`` tensors on ``device``, with one colour table:
    spheres, planes, cylinders, then the mesh."""

    def __init__(self, arrays: dict, eps: float, device, dtype=torch.float32):
        self.device, self.dtype, self.eps = torch.device(device), dtype, eps
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
        torch.backends.cudnn.allow_tf32 = False

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)

        self.sph_c, self.sph_r = t(arrays["sphere_center"]), t(arrays["sphere_radius"])
        self.pl_p, self.pl_n = t(arrays["plane_point"]), t(arrays["plane_normal"])
        colors = [arrays["sphere_color"], arrays["plane_color"]]
        self.n_cyl = 0
        if "cylinder_base" in arrays:
            axis = np.asarray(arrays["cylinder_axis"], np.float64)
            axis = (axis / np.linalg.norm(axis, axis=1, keepdims=True)).astype(np.float32)
            self.cy_b, self.cy_a = t(arrays["cylinder_base"]), t(axis)
            self.cy_r, self.cy_h = t(arrays["cylinder_radius"]), t(arrays["cylinder_height"])
            self.n_cyl = self.cy_b.shape[0]
            colors.append(arrays["cylinder_color"])
        self.n_tri = 0
        if "mesh_verts" in arrays:
            self.tri, self.tri_n = t(arrays["mesh_verts"]), t(arrays["mesh_normals"])
            self.n_tri = self.tri.shape[0]
            self.acc = Clusters(self.tri)
            colors.append(arrays["mesh_color"])
        self.colors = t(np.concatenate(colors))
        self.off_plane = self.sph_c.shape[0]
        self.off_cyl = self.off_plane + self.pl_p.shape[0]
        self.off_mesh = self.off_cyl + self.n_cyl
        self.light_p, self.light_i = t(arrays["light_position"]), t(arrays["light_intensity"])


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


# ---- families: (t (N,), normal (N, 3), colour index (N,)), t = inf on a miss ----

def _sphere_t(s, o, d):
    """(N, S) candidate t of every sphere (sphere.cpp:26-160: origin
    strictly outside, closest approach inside, both roots in front)."""
    L = s.sph_c[None] - o[:, None]
    dist_sq = _dot(L, L)
    r_sq = (s.sph_r * s.sph_r)[None]
    tca = _dot(L, d[:, None])
    d2 = dist_sq - tca * tca
    thc = torch.sqrt(torch.clamp_min(r_sq - d2, 0.0))
    t0, t1 = tca - thc, tca + thc
    valid = (dist_sq > r_sq) & (d2 < r_sq) & (t0 >= 0) & (t1 >= 0)
    return torch.where(valid, torch.minimum(t0, t1), INF)


def _plane_t(s, o, d):
    """(N, P) candidate t (plane.cpp:27-139: |d.n| > eps, t > eps)."""
    denom = _dot(d[:, None], s.pl_n[None])
    num = _dot(s.pl_p[None] - o[:, None], s.pl_n[None])
    ok = torch.abs(denom) > s.eps
    t = torch.where(ok, num / torch.where(ok, denom, 1.0), 0.0)
    return torch.where(ok & (t > s.eps), t, INF)


def _cylinder_t(s, o, d, clip):
    """(N, C, 3) candidates [body, bottom cap, top cap] (cylinder.cpp:35-210)."""
    eps = s.eps
    ax, base = s.cy_a[None], s.cy_b[None]
    r_sq, h = (s.cy_r * s.cy_r)[None], s.cy_h[None]
    o3, d3 = o[:, None], d[:, None]
    dp = o3 - base
    d_a = _dot(d3, ax)
    v_rem = d3 - d_a[..., None] * ax
    dp_a = _dot(dp, ax)
    dp_rem = dp - dp_a[..., None] * ax
    a = _dot(v_rem, v_rem)
    b = 2.0 * _dot(v_rem, dp_rem)
    c = _dot(dp_rem, dp_rem) - r_sq
    disc = b * b - 4.0 * a * c
    ok = (disc >= eps) & (a != 0)
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    two_a = torch.where(ok, 2.0 * a, 1.0)
    t_sub, t_add = (-b - sq) / two_a, (-b + sq) / two_a
    t_body = torch.where((t_sub < 0) & (t_add < 0), INF,
                         torch.where(t_sub < 0, t_add, torch.where(t_add < 0, t_sub, torch.minimum(t_sub, t_add))))
    ok = ok & torch.isfinite(t_body)
    p = o3 + d3 * torch.where(ok, t_body, 0.0)[..., None]
    along = _dot(p - base, ax)
    t_body = torch.where(ok & (along >= 0) & (along <= h), t_body, INF)

    def cap(offset):
        center = base + ax * offset[..., None]
        par = torch.abs(d_a) >= eps
        t = torch.where(par, _dot(center - o3, ax) / torch.where(par, d_a, 1.0), 0.0)
        good = par & (t >= eps) & (t <= clip[:, None])
        q = o3 + d3 * torch.where(good, t, 0.0)[..., None] - center
        return torch.where(good & (_dot(q, q) <= r_sq), t, INF)

    return torch.stack([t_body, cap(torch.zeros_like(h)), cap(h)], dim=-1)


def _first_min(t):
    idx = torch.argmin(t, dim=1)
    return torch.gather(t, 1, idx[:, None])[:, 0], idx


def _families_closest(s, o, d, clip):
    """The closest sphere, plane or cylinder hit below ``clip`` ->
    (t, normal, colour index)."""
    n = o.shape[0]
    t, i = _first_min(_sphere_t(s, o, d))
    t = torch.where(t < clip, t, INF)
    p = o + d * torch.where(torch.isfinite(t), t, 0.0)[:, None]
    delta = p - s.sph_c[i]
    normal = delta * torch.rsqrt(torch.clamp_min(_dot(delta, delta), 1e-30))[:, None]
    cidx = i

    tp, ip = _first_min(_plane_t(s, o, d))
    take = (tp < torch.minimum(t, clip)) & (tp < t)
    t = torch.where(take, tp, t)
    normal = torch.where(take[:, None], s.pl_n[ip], normal)
    cidx = torch.where(take, ip + s.off_plane, cidx)

    if s.n_cyl:
        cl = torch.minimum(t, clip)
        tc, ic = _first_min(_cylinder_t(s, o, d, cl).reshape(n, -1))
        take = (tc < cl) & (tc < t)
        ci, kind = ic // 3, ic % 3
        ax, base = s.cy_a[ci], s.cy_b[ci]
        p = o + d * torch.where(take, tc, 0.0)[:, None]
        radial = p - base - ax * _dot(p - base, ax)[:, None]
        n_body = radial * torch.rsqrt(torch.clamp_min(_dot(radial, radial), 1e-30))[:, None]
        n_cap = torch.where((_dot(d, ax) > 0)[:, None], -ax, ax)
        t = torch.where(take, tc, t)
        normal = torch.where(take[:, None], torch.where((kind == 0)[:, None], n_body, n_cap), normal)
        cidx = torch.where(take, ci + s.off_cyl, cidx)
    return t, normal, cidx


def _families_any(s, o, d, tmax):
    blocked = torch.any(_sphere_t(s, o, d) < tmax[:, None], dim=1)
    blocked |= torch.any(_plane_t(s, o, d) < tmax[:, None], dim=1)
    if s.n_cyl:
        blocked |= torch.any(_cylinder_t(s, o, d, tmax).reshape(o.shape[0], -1) < tmax[:, None], dim=1)
    return blocked


# ---- triangles ----

def _morton(q):
    def part(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249
    return part(q[:, 0]) | (part(q[:, 1]) << 1) | (part(q[:, 2]) << 2)


def _mt(A, e1, e2, o, d):
    """Moller-Trumbore (triangle.cpp:22-140) of rays o, d (..., 3) against
    triangles (..., 3): -> (t, u, v), t = inf where the strict tests fail
    (det != 0, 0 < u < 1, v > 0, u + v < 1, t > 0)."""
    pvec = torch.linalg.cross(d, e2, dim=-1)
    det = _dot(pvec, e1)
    ok = det != 0
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvec = o - A
    u = _dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    ok = ok & (u > 0) & (u < 1) & (v > 0) & (u + v < 1) & (t > 0)
    return torch.where(ok, t, INF), u, v


def _boxes(o, inv, lo, hi, tmax):
    """Conservative slab test of rays (P, 3) against boxes (P, 3): False
    only where the ray's segment (0, tmax) surely misses the box."""
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    tn = torch.minimum(t1, t2).amax(dim=-1)
    tf = torch.maximum(t1, t2).amin(dim=-1)
    return ~(tn > tf) & ~(tf < 0) & ~(tn > tmax)


class Clusters:
    """Triangles in Morton order, in clusters of CLUSTER and groups of
    GROUP clusters, each with its widened box.  Padding slots hold a
    degenerate triangle (det = 0) and the index -1."""

    def __init__(self, tri):
        dev, dt = tri.device, tri.dtype
        n = tri.shape[0]
        cen = tri.float().mean(dim=1)
        lo, hi = cen.amin(dim=0), cen.amax(dim=0)
        q = ((cen - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023).long().clamp(0, 1023)
        order = torch.argsort(_morton(q), stable=True)
        per = CLUSTER * GROUP
        pad = (-n) % per
        order = torch.cat([order, torch.full((pad,), -1, dtype=torch.long, device=dev)])
        live = order >= 0
        v = torch.where(live[:, None, None], tri[order.clamp_min(0)], 0.0)
        self.n_cl = order.shape[0] // CLUSTER
        self.idx = order.view(self.n_cl, CLUSTER)
        self.A = v[:, 0].reshape(self.n_cl, CLUSTER, 3)
        self.e1 = (v[:, 1] - v[:, 0]).reshape(self.n_cl, CLUSTER, 3)
        self.e2 = (v[:, 2] - v[:, 0]).reshape(self.n_cl, CLUSTER, 3)
        vf = tri.float()[order.clamp_min(0)]
        big = torch.tensor(INF, device=dev)
        vlo = torch.where(live[:, None, None], vf, big).amin(dim=1).view(self.n_cl, CLUSTER, 3).amin(dim=1)
        vhi = torch.where(live[:, None, None], vf, -big).amax(dim=1).view(self.n_cl, CLUSTER, 3).amax(dim=1)
        self.lo, self.hi = (vlo - WIDEN).to(dt), (vhi + WIDEN).to(dt)
        self.glo = (vlo.view(-1, GROUP, 3).amin(dim=1) - WIDEN).to(dt)
        self.ghi = (vhi.view(-1, GROUP, 3).amax(dim=1) + WIDEN).to(dt)

    def _pairs(self, o, d, tmax):
        """(ray, cluster) pairs whose boxes a ray's segment may meet."""
        inv = 1.0 / d
        rays, groups = [], []
        step = max(1, PAIR_CHUNK // self.glo.shape[0])
        for r0 in range(0, o.shape[0], step):
            sl = slice(r0, r0 + step)
            m = _boxes(o[sl, None], inv[sl, None], self.glo[None], self.ghi[None], tmax[sl, None])
            r, g = torch.nonzero(m, as_tuple=True)
            rays.append(r + r0)
            groups.append(g)
        r, g = torch.cat(rays), torch.cat(groups)
        out_r, out_c = [r[:0]], [g[:0]]
        step = max(1, PAIR_CHUNK // GROUP)
        for p0 in range(0, r.shape[0], step):
            rr, gg = r[p0:p0 + step], g[p0:p0 + step]
            c = (gg[:, None] * GROUP + torch.arange(GROUP, device=o.device)[None]).reshape(-1)
            rr = rr.repeat_interleave(GROUP)
            keep = _boxes(o[rr], inv[rr], self.lo[c], self.hi[c], tmax[rr])
            out_r.append(rr[keep])
            out_c.append(c[keep])
        return torch.cat(out_r), torch.cat(out_c)

    def _pair_t(self, o, d, tmax, r, c):
        """(t (P, CLUSTER), original index (P, CLUSTER)) of each pair, t =
        inf where a slot is not hit below the ray's tmax."""
        t, _, _ = _mt(self.A[c], self.e1[c], self.e2[c], o[r][:, None], d[r][:, None])
        return torch.where(t < tmax[r][:, None], t, INF), self.idx[c]

    def closest(self, o, d, tmax):
        """(t (N,), triangle index (N,), -1 for none): the closest hit below
        ``tmax``, the lowest index among equal t."""
        n = o.shape[0]
        r, c = self._pairs(o, d, tmax)
        none = torch.iinfo(torch.int64).max
        key = torch.full((n,), none, dtype=torch.int64, device=o.device)
        step = max(1, PAIR_CHUNK // CLUSTER)
        for p0 in range(0, r.shape[0], step):
            rr, cc = r[p0:p0 + step], c[p0:p0 + step]
            t, idx = self._pair_t(o, d, tmax, rr, cc)
            bits = t.float().view(torch.int32).long()  # monotone for t >= 0
            k = torch.where(torch.isfinite(t), (bits << 32) | idx.clamp_min(0), none).amin(dim=1)
            key.scatter_reduce_(0, rr, k, reduce="amin")
        hit = key != none
        t = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32), INF).to(o.dtype)
        return t, torch.where(hit, key & 0xFFFFFFFF, -1)

    def any(self, o, d, tmax):
        """(N,) bool: some triangle hit below ``tmax``."""
        r, c = self._pairs(o, d, tmax)
        count = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
        step = max(1, PAIR_CHUNK // CLUSTER)
        for p0 in range(0, r.shape[0], step):
            rr, cc = r[p0:p0 + step], c[p0:p0 + step]
            t, _ = self._pair_t(o, d, tmax, rr, cc)
            count.index_add_(0, rr, torch.isfinite(t).any(dim=1).int())
        return count > 0


def closest_hit(s, o, d, tmax):
    """-> (t, normal, colour index, hit mask) of the closest hit below tmax."""
    t, normal, cidx = _families_closest(s, o, d, tmax)
    if s.n_tri:
        clip = torch.minimum(t, tmax)
        tt, ti = s.acc.closest(o, d, clip)
        take = tt < t
        i = ti.clamp_min(0)
        tri = s.tri[i]
        _, u, v = _mt(tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], o, d)
        nrm = s.tri_n[i]
        n_tri = (1.0 - (u + v))[:, None] * nrm[:, 0] + u[:, None] * nrm[:, 1] + v[:, None] * nrm[:, 2]
        t = torch.where(take, tt, t)
        normal = torch.where(take[:, None], n_tri, normal)
        cidx = torch.where(take, torch.full_like(cidx, s.off_mesh), cidx)
    return t, normal, cidx, t < tmax


def occluded(s, o, d, tmax):
    blocked = _families_any(s, o, d, tmax)
    if s.n_tri:
        blocked |= s.acc.any(o, d, torch.where(blocked, -1.0, tmax))
    return blocked


def primary_dirs(width: int, height: int, pixels, device, dtype=torch.float32):
    """Raw (un-normalised) primary directions of the pixels ``pixels``
    (row-major indices), as main.cpp:275-299 sweeps them."""
    f32 = dict(dtype=torch.float32, device=device)
    pixels = torch.as_tensor(pixels, device=device)
    ratio = torch.tensor(float(width), **f32) / torch.tensor(float(height), **f32)
    row, col = (pixels // width).to(torch.float32), (pixels % width).to(torch.float32)
    x = -ratio + col * (2.0 * ratio / width)
    y = 1.0 - row * (2.0 / height)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1).to(dtype)


def trace(s, d_raw, depth: int, chunk: int = 1 << 18, counts: dict = None):
    """Per bounce k < depth: (active (N,), colour index (N,), light
    coefficients (N, L)) of the rays with raw primary directions ``d_raw``.
    ``counts``, if given, gains the queries these semantics make:
    ``closest`` (one a ray still active at a bounce) and ``shadow`` (one a
    light that faces an active hit, ``shade > 0``)."""
    parts = [_trace_chunk(s, d_raw[i:i + chunk], depth, counts) for i in range(0, d_raw.shape[0], chunk)]
    return [tuple(torch.cat(x) for x in zip(*bounce)) for bounce in zip(*parts)]


def _trace_chunk(s, d_raw, depth, counts=None):
    n = d_raw.shape[0]
    d = d_raw / torch.sqrt(_dot(d_raw, d_raw))[:, None]
    o = torch.tensor(ORIGIN, dtype=s.dtype, device=s.device).expand(n, 3)
    active = torch.ones((n,), dtype=torch.bool, device=s.device)
    lp = s.light_p
    out = []
    for _ in range(depth):
        if counts is not None:
            counts["closest"] = counts.get("closest", 0) + int(active.sum())
        tmax = torch.where(active, INF, -1.0).to(s.dtype)
        t, normal, cidx, mask = closest_hit(s, o, d, tmax)
        active = active & mask
        p = o + d * torch.where(mask, t, 0.0)[:, None]
        to_light = lp[None] - p[:, None]  # (N, L, 3)
        dist_sq = torch.clamp_min(_dot(to_light, to_light), 1e-30)
        ldir = to_light * torch.rsqrt(dist_sq)[..., None]
        n_dot_l = _dot(normal[:, None], ldir)
        refl = ldir - 2.0 * n_dot_l[..., None] * normal[:, None]
        spec = torch.clamp_min(_dot(refl, d_raw[:, None]), 0.0) ** SPECULAR_POW
        shade = torch.clamp_min(n_dot_l, 0.0) + spec
        relevant = (shade > 0) & active[:, None]
        if counts is not None:
            counts["shadow"] = counts.get("shadow", 0) + int(relevant.sum())
        dist = torch.sqrt(_dot(to_light, to_light))
        sdir = to_light / torch.clamp_min(dist, 1e-30)[..., None]
        so = p[:, None] + sdir * SHADOW_OFFSET
        smax = torch.where(relevant, dist, -1.0)
        blocked = occluded(s, so.reshape(-1, 3), sdir.reshape(-1, 3), smax.reshape(-1)).view(n, -1)
        coef = torch.where(relevant & ~blocked, shade / dist_sq, 0.0)
        out.append((active, cidx, coef))
        d_new = d - 2.0 * _dot(normal, d)[:, None] * normal
        o_new = p + d_new * s.eps
        o = torch.where(active[:, None], o_new, o)
        d = torch.where(active[:, None], d_new, d)
    return out


def shade(terms, colors, intensity):
    """(N, 3) linear colours of the traced rays, given the colour table and
    the light intensities (differentiable in both)."""
    final = None
    for k, (active, cidx, coef) in enumerate(terms):
        factor = AMBIENT + torch.sum(coef * intensity[None], dim=-1)
        color = torch.index_select(colors, 0, cidx) * factor[:, None]  # backward: one index_add
        if final is None:
            final = torch.zeros_like(color)
        w = 2.0 ** -k
        final = torch.where(active[:, None], (1.0 - w) * final + w * color, final)
    return final


def quantize_u8(c):
    """clamp(c * 255, 0, 255) and a truncating cast (main.cpp:168-171)."""
    return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.uint8)


def render_pixels(s, width: int, height: int, depth: int, pixels, counts: dict = None):
    """u8 colours (K, 3) of the pixels ``pixels`` of a width x height frame
    (``counts``: see ``trace``)."""
    terms = trace(s, primary_dirs(width, height, pixels, s.device, s.dtype), depth, counts=counts)
    return quantize_u8(shade(terms, s.colors, s.light_i))
