"""Batched Möller–Trumbore ray-triangle intersection.

Counterpart of ``dod_raytracer_tpu.ops.triangle``: the reference's 8-wide
AVX kernel (``triangle.cpp:22-140``) with its validity ladder

  det  = (d x AC) . AB ;  valid = |det| > 0       (strict, NO eps — :73)
  u    = (tvec . pvec)/det ; valid &= 0 < u < 1    (strict — :85-87)
  v    = (d . qvec)/det    ; valid &= v > 0, u+v<1 (strict — :98-100)
  t    = (AC . qvec)/det   ; valid &= 0 < t < clip (strict — :109-111)

Hit attributes (triangle.cpp:169-174): the barycentric blend of the
smooth vertex normals, deliberately not renormalized, and the owning
mesh's color.  All-zero padding triangles fail the det test.
"""

from __future__ import annotations

import torch

from ..utils.math import cross, dot, safe_div
from .ray import INF, FamilyHit, take


def _cross(a, b):
    """a x b of component triples, every product and difference its own
    IEEE operation."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0


def _dot(a, b):
    """(a0*b0 + a1*b1) + a2*b2 of component triples, one IEEE operation
    at a time."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def plucker_row(o, d):
    """(N, 6) ray rows [d, o x d] of the Plücker edge products, each
    operation its own (csrc/kd_leaf.cuh plucker_row)."""
    return torch.stack([*d.unbind(-1), *_cross(o.unbind(-1), d.unbind(-1))], dim=-1)


def plucker_inside(row, g):
    """The CUDA kernels' leaf test: Plücker edge signs of per-ray blocks.

    Args:
      row: (N, 6) ray rows (``plucker_row``).
      g: (N, 6, 3, K) rows 0-5 of the edge sections s0..s2 of each ray's
        ``block_g`` block (``accel.kdtree.pack_block_g``), K slots.
    Returns: (N, K) bool, True where the three signs are all > 0 or all < 0.

    Each sign is summed in row order, every product and sum rounded on its
    own, as ``csrc/kd_leaf.cuh`` ``test_block`` does: the same bits on the
    CPU and on the card.  Near an edge this is not the barycentric test of
    ``mt_t_edges`` without ``inside``: the two can disagree on which of two
    triangles sharing an edge a ray meets, or whether it meets one.
    """
    signs = []
    for e in range(3):
        s = row[:, 0, None] * g[:, 0, e]
        for k in range(1, 6):
            s = s + row[:, k, None] * g[:, k, e]
        signs.append(s)
    s0, s1, s2 = signs
    return ((s0 > 0.0) & (s1 > 0.0) & (s2 > 0.0)) | ((s0 < 0.0) & (s1 < 0.0) & (s2 < 0.0))


def mt_t_edges(A, e1, e2, o, d, inside=None):
    """Candidate t from precomputed-edge blocks.

    Args:
      A, e1, e2: (N, K, 3) per-ray triangle blocks (A, B-A, C-A).
      o, d: (N, 3) rays.
      inside: optional (N, K) bool from ``plucker_inside``: where given it
        takes the place of the barycentric tests on u and v, as in the CUDA
        kernels' leaf test.
    Returns: t (N, K), +inf invalid (t > 0 enforced).

    The cross and dot products are spelled out one operation per tensor
    op, so no device fuses or reorders them: t is the same bits on the CPU
    and on the card, and the CUDA kernels (csrc/kd_leaf.cuh mt_distance)
    repeat exactly these operations.
    """
    d_b = d[:, None, :].unbind(-1)
    e1c, e2c = e1.unbind(-1), e2.unbind(-1)
    pvec = _cross(d_b, e2c)
    det = _dot(pvec, e1c)
    valid = torch.abs(det) > 0.0
    inv_det = safe_div(torch.ones_like(det), det, valid)
    tvec = (o[:, None, :] - A).unbind(-1)
    qvec = _cross(tvec, e1c)
    if inside is None:
        u = _dot(tvec, pvec) * inv_det
        v = _dot(d_b, qvec) * inv_det
        valid = valid & (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0)
    else:
        valid = valid & inside
    t = _dot(e2c, qvec) * inv_det
    valid = valid & (t > 0.0)
    return torch.where(valid, t, INF)


def mt_t(verts, o, d):
    """Candidate t for rays x triangles.

    Args:
      verts: (K, 3, 3) triangles shared by all rays, or (N, K, 3, 3)
        per-ray triangles [corner, xyz].
      o, d: (N, 3) rays.
    Returns:
      t: (N, K) with +inf where invalid (t > 0 enforced; caller clips).
    """
    A = verts[..., 0, :]
    if verts.ndim == 3:
        verts = verts[None]
        A = A[None]
    ab = verts[..., 1, :] - A
    ac = verts[..., 2, :] - A
    shape = torch.broadcast_shapes(ab.shape, (o.shape[0], 1, 3))
    return mt_t_edges(A.expand(shape), ab.expand(shape), ac.expand(shape), o, d)


def mt_single(tri, o, d, valid):
    """(t, u, v) of one triangle per ray.

    Args:
      tri: (N, 3, 3) the gathered winning triangle per ray.
      valid: (N,) bool — where False, outputs are zeros (safe grads).
    """
    A, B, C = tri[:, 0, :], tri[:, 1, :], tri[:, 2, :]
    ab = B - A
    ac = C - A
    pvec = cross(d, ac)
    det = dot(pvec, ab)
    inv_det = safe_div(torch.ones_like(det), det, valid)
    tvec = o - A
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, ab)
    v = dot(d, qvec) * inv_det
    t = dot(ac, qvec) * inv_det
    return t, u, v


def triangle_hit_attrs(tris, o, d, tri_idx, hit, mesh_colors=None) -> FamilyHit:
    """Hit attributes recomputed from the winning triangle index, with the
    reference's semantics (triangle.cpp:169-174)."""
    idx = torch.clamp(tri_idx, 0, tris.verts.shape[0] - 1).long()
    if torch.is_grad_enabled() and (tris.verts.requires_grad or tris.normals.requires_grad):
        # a miss's row never wins the merge and takes a zero gradient: point
        # the misses at rows spread over the table instead of row 0, so that
        # the backward's atomic adds of those zeros do not queue on one row
        spread = torch.arange(idx.shape[0], device=idx.device) % tris.verts.shape[0]
        idx = torch.where(hit, idx, spread)
    tri = take(tris.verts, idx)  # (N, 3, 3)
    t, u, v = mt_single(tri, o, d, hit)
    t = torch.where(hit, t, INF)
    w0 = 1.0 - (u + v)
    nrm = take(tris.normals, idx)  # (N, 3, 3) rows = AN, BN, CN
    normal = w0[:, None] * nrm[:, 0, :] + u[:, None] * nrm[:, 1, :] + v[:, None] * nrm[:, 2, :]
    if mesh_colors is None:
        color = torch.zeros_like(normal)
    else:
        color = take(mesh_colors, take(tris.mesh_id, idx).long())
    return FamilyHit(t=t, normal=normal, color=color)


def first_min(t):
    """(N, K) -> (min over each row (N,), the lowest column that holds it
    (N,) int64): the tie-break spelled out, as the Pallas kernels' (t,
    column) min does, instead of left to a reduction's choice on the card."""
    t_min = t.amin(dim=1)
    cols = torch.arange(t.shape[1], device=t.device)
    col = torch.where(t == t_min[:, None], cols, t.shape[1]).amin(dim=1)
    return t_min, col.clamp_max(t.shape[1] - 1)


def closest_edges(A, e1, e2, o, d, chunk: int = 2048):
    """Möller–Trumbore closest hit of every ray over all triangles given as
    corners and edges: A, e1 = B - A, e2 = C - A, each (T, 3) -> (t_best
    (N,), idx (N,) i32; (inf, 0) for a miss).

    The triangles are scanned in fixed chunks; within and across chunks the
    lowest index wins a tie (the reference's lane scan, triangle.cpp:126-139).
    This is the plain version of the CUDA Möller–Trumbore kernel
    (``ops.mt``), which computes ``mt_t_edges`` with the same roundings.
    """
    return _closest_over(((base, mt_t_edges(A[None, base:base + chunk], e1[None, base:base + chunk],
                                            e2[None, base:base + chunk], o, d))  # (N, chunk)
                          for base in range(0, A.shape[0], chunk)), o)


def _closest_over(chunks, o):
    """The running closest hit over ``chunks`` of (base, t (N, chunk)) ->
    (t_best (N,), idx (N,) i32; (inf, 0) for a miss); the lowest index
    wins a tie, within a chunk and across chunks."""
    n = o.shape[0]
    t_best = torch.full((n,), INF, dtype=torch.float32, device=o.device)
    idx_best = torch.zeros((n,), dtype=torch.int32, device=o.device)
    for base, t in chunks:
        t_c, a = first_min(t)
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        idx_best = torch.where(better, (a + base).to(torch.int32), idx_best)
    return t_best, idx_best


def brute_force_closest(verts, o, d, chunk: int = 2048):
    """Scan all T triangles (T, 3, 3); returns (t_best (N,), idx (N,))."""
    A = verts[:, 0, :]
    return closest_edges(A, verts[:, 1, :] - A, verts[:, 2, :] - A, o, d, chunk)


def intersect_triangles_brute(tris, mesh_colors, o, d, t_max, chunk: int = 2048) -> FamilyHit:
    """Closest hit over all triangles: the brute force picks the winner
    without gradient (the JAX package's stop_gradient on the vertices and
    the rays), ``triangle_hit_attrs`` recomputes its hit with gradient."""
    with torch.no_grad():
        t_best, idx = brute_force_closest(tris.verts.detach(), o.detach(), d.detach(), chunk)
        hit = t_best < t_max.detach()
    return triangle_hit_attrs(tris, o, d, idx, hit, mesh_colors)


def edge_rows(verts):
    """(T, 3, 3) triangles -> (1, 6, 3, T): rows 0-5 of the edge sections
    s0..s2 of each triangle, packed as ``accel.kdtree.pack_block_g`` packs
    a leaf block (the rows ``plucker_inside`` reads)."""
    from ..accel.kdtree import pack_block_g

    g = pack_block_g(verts[None])  # (1, 16, 5 * Spad)
    spad = g.shape[2] // 5
    return g[:, :6, :3 * spad].reshape(1, 6, 3, spad)[..., :verts.shape[0]]


def block_edge_rows(kd, num_tris: int):
    """The same rows read back out of a built tree's ``block_g``: (1, 6, 3,
    num_tris), each triangle's from a slot of ``block_orig`` that holds it
    (every triangle lies in some leaf block).  These are the very bits the
    kernels and the plain walks test."""
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    g = kd.block_g[:, :6, :3 * spad].reshape(B, 6, 3, spad)[..., :S]
    flat = g.permute(1, 2, 0, 3).reshape(6, 3, B * S)
    orig = kd.block_orig.reshape(-1).long()
    live = orig >= 0
    out = torch.zeros((6, 3, num_tris), dtype=g.dtype, device=g.device)
    out[:, :, orig[live]] = flat[:, :, live]
    return out[None]


def _edge_sign_t(verts, o, d, g=None, chunk: int = 2048):
    """Yield (base, t (N, chunk)) of every ray against each chunk of the
    triangles under the kernels' leaf test: ``plucker_inside`` on the edge
    rows ``g`` ((1, 6, 3, T), default ``edge_rows(verts)``), then
    ``mt_t_edges`` with ``inside``; +inf where a triangle is not hit."""
    row = plucker_row(o, d)
    A = verts[:, 0, :]
    e1, e2 = verts[:, 1, :] - A, verts[:, 2, :] - A
    for base in range(0, verts.shape[0], chunk):
        sl = slice(base, base + chunk)
        gc = edge_rows(verts[sl]) if g is None else g[..., sl]
        inside = plucker_inside(row, gc)
        yield base, mt_t_edges(A[None, sl], e1[None, sl], e2[None, sl], o, d, inside)


def edge_sign_brute_closest(verts, o, d, g=None, chunk: int = 2048):
    """Brute force under the kernels' own leaf test: every triangle
    (T, 3, 3) through the Plücker edge signs (``plucker_inside`` on rows
    packed as ``pack_block_g`` packs them, or on ``g`` (1, 6, 3, T)), then
    the Möller–Trumbore t (``mt_t_edges`` with ``inside``) -> (t_best (N,),
    idx (N,) i32; (inf, 0) for a miss), the lowest index winning a tie.

    A plain reference for checks, used by no render path: near a shared
    edge the kd walks and kernels must equal it (ties of bit-equal t
    aside), where ``brute_force_closest``'s barycentric test may differ."""
    return _closest_over(_edge_sign_t(verts, o, d, g, chunk), o)


def edge_sign_brute_any(verts, o, d, t_max, g=None, chunk: int = 2048) -> torch.Tensor:
    """The any-hit sibling of ``edge_sign_brute_closest``: (N,) bool, True
    where some triangle passes the edge signs with 0 < t < t_max."""
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for _, t in _edge_sign_t(verts, o, d, g, chunk):
        out = out | torch.any(t < t_max[:, None], dim=1)
    return out


def occluded_triangles_brute(verts, o, d, t_max, chunk: int = 2048) -> torch.Tensor:
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for base in range(0, verts.shape[0], chunk):
        t = mt_t(verts[base:base + chunk], o, d)
        out = out | torch.any(t < t_max[:, None], dim=1)
    return out
