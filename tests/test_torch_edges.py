"""Shared edges: the kernels' own leaf test as a brute force.

The port's kd walks and CUDA kernels test Plücker edge signs on
``block_g`` (``ops/triangle.py`` ``plucker_inside``), then take the
Möller–Trumbore t (``mt_t_edges`` with ``inside``); the brute force of
both packages tests barycentrics.  On rays that meet a triangle within
rounding of a shared edge the two disagree.  ``edge_sign_brute_closest``
and ``edge_sign_brute_any`` run every triangle through the kernels' test,
so the plain walks (the kernels' plain versions) must equal them with no
edge excuse: hit masks and any-hit bits equal, t bit-equal, and a prim may
differ only at a tie of bit-equal t.  Away from edges they equal the
barycentric brute force.

Ray sets: rays aimed at edge midpoints and at vertices of random triangles
(where the two tests disagree), and random rays, on the teapot and on the
JAX tests' at-scale dragon (40,000 triangles, with treelet tables).
"""

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu_torch.mesh import load_mesh_asset, procedural_dragon
from dod_raytracer_tpu_torch.ops import triangle as tri
from dod_raytracer_tpu_torch.ops.traverse import _stack_depth, traverse_forest_plain, traverse_plain

N = 1024  # rays a set (the dragon's: a quarter, for the brute force's time over 40,000 triangles)
EDGE_EPS = 1e-3  # edge margin (``edge_margin``) under which the two tests may disagree
SCENES = {"teapot": dict(MaxPrims=96, leaf_chunk_lanes=48), "dragon40k": dict(MaxPrims=32, leaf_chunk_lanes=32)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    tv, tn = load_mesh_asset("teapot") if request.param == "teapot" else procedural_dragon(num_tris=40000)
    b = T.SceneBuilder()
    b.add_mesh(tv, tn)
    cfg = T.Config(**SCENES[request.param])
    return request.param, b.build(cfg, device="cpu"), cfg


def make_rays(verts, case, seed, n):
    """(o, d, t_max) of n rays from [-6, 6]^3: aimed at edge midpoints
    ('edges'), at vertices ('vertices') or at random points ('random');
    t_max inf, but a quarter clipped short for the any-hit queries."""
    rng = np.random.default_rng(seed)
    v = verts.numpy()
    o = ((rng.random((n, 3)) * 2 - 1) * 6.0).astype(np.float32)
    k, c = rng.integers(0, v.shape[0], n), rng.integers(0, 3, n)
    if case == "edges":
        aim = (v[k, c] + v[k, (c + 1) % 3]) * 0.5
    elif case == "vertices":
        aim = v[k, c]
    else:
        aim = (rng.random((n, 3)) * 2 - 1) * 1.5
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((n,), np.inf, np.float32)
    t_max[: n // 4] = (np.linalg.norm(aim - o, axis=1)[: n // 4] * rng.random(n // 4) * 1.5).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32)), torch.from_numpy(t_max)


def edge_margin(verts, prim, o, d):
    """How far each ray's crossing of triangle ``prim`` lies from the
    triangle's nearest edge, in float64: the barycentric distance times
    the sine of the ray's angle to the triangle's plane (the float32
    barycentrics of a grazing ray carry an error that grows as that sine
    shrinks).  inf where ``prim`` is -1."""
    tri_ = verts[prim.clamp_min(0).long()].double()
    o, d = o.double(), d.double()
    A, e1, e2 = tri_[:, 0], tri_[:, 1] - tri_[:, 0], tri_[:, 2] - tri_[:, 0]
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(-1)
    tvec = o - A
    u = (tvec * p).sum(-1) / det
    v = (d * torch.linalg.cross(tvec, e1)).sum(-1) / det
    sine = det.abs() / (torch.linalg.cross(e1, e2).norm(dim=-1) * d.norm(dim=-1))
    margin = torch.minimum(torch.minimum(u.abs(), v.abs()), (1.0 - u - v).abs()) * sine
    return torch.where(prim >= 0, margin, float("inf"))


def assert_closest_equal(got, ref, label):
    """(t, prim, hit) equal with no edge excuse: hits equal, t bit-equal
    where hit, prims equal but at ties (both t bit-equal, as they are)."""
    (tg, _, hg), (tr, _, hr) = got, ref
    assert torch.equal(hg, hr), f"{label}: {int((hg != hr).sum())} hit masks differ"
    # so a prim differs only where both t are bit-equal: a tie
    assert torch.equal(tg[hr].view(torch.int32), tr[hr].view(torch.int32)), f"{label}: t differs"


@pytest.mark.parametrize("case", ["edges", "vertices", "random"])
def test_edge_sign_brute_force_equals_the_plain_walks(scene, case):
    name, sc, cfg = scene
    verts, kd = sc.triangles.verts, sc.kd
    seed = {"edges": 0, "vertices": 1, "random": 2}[case]
    n = N if name == "teapot" else N // 4
    o, d, t_max = make_rays(verts, case, seed, n)
    inf = torch.full((n,), float("inf"))
    depth = _stack_depth(kd, cfg)
    g = tri.block_edge_rows(kd, verts.shape[0])
    # the rows packed from the vertices are the very bits of the tree's block_g
    assert torch.equal(tri.edge_rows(verts).view(torch.int32), g.view(torch.int32))

    te, ie = tri.edge_sign_brute_closest(verts, o, d, g=g)
    he = te < inf
    any_e = tri.edge_sign_brute_any(verts, o, d, t_max)
    tb, ib = tri.brute_force_closest(verts, o, d)
    hb = tb < inf
    walks = {"plain": traverse_plain}
    if kd.tre_tbl is not None:
        walks["forest_plain"] = traverse_forest_plain
    for wname, walk in walks.items():
        tw, pw, fw = walk(kd, o, d, inf, depth, False)
        assert_closest_equal((tw, pw, fw & (tw < inf)), (te, ie, he), f"{name} {case} closest vs {wname}")
        hit_any = walk(kd, o, d, t_max, depth, True)[2]
        assert torch.equal(hit_any, any_e), f"{name} {case} any vs {wname}"

    # against the barycentric brute force: equal away from edges
    near = ((he & (edge_margin(verts, torch.where(he, ie, -1), o, d) < EDGE_EPS))
            | (hb & (edge_margin(verts, torch.where(hb, ib, -1), o, d) < EDGE_EPS)))
    differ = (he != hb) | (he & hb & (ie != ib) & (te != tb))
    away = ~near
    assert torch.equal(he[away], hb[away]), f"{name} {case}: hit masks differ away from edges"
    both = away & he
    assert torch.equal(te[both].view(torch.int32), tb[both].view(torch.int32))
    flips = both & (ie != ib)
    assert not bool(flips.any()) or torch.equal(te[flips], tb[flips])  # ties only
    any_b = tri.occluded_triangles_brute(verts, o, d, t_max)
    assert torch.equal(any_b[away], any_e[away])
    if case == "edges":  # the case this reference exists for: the two tests disagree at an edge
        assert bool(differ.any()) or not torch.equal(any_b, any_e), f"{name}: no ray at an edge disagrees"
        assert not bool((differ & away).any())
    if case == "random":
        assert int(away.sum()) > n // 2  # most random rays are away from edges
