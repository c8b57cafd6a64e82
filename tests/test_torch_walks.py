"""The mega and forest walks: the port's plain walks (the CUDA kernels'
plain versions, taken for CPU tensors) vs the JAX package's Pallas mega
and forest kernels, run in interpret mode as ``tests/test_kdtree.py``
runs them, and the backend dispatch vs the JAX package's.

Parity rules (tests/test_kdtree.py TestMegaTraversal / TestForestTraversal):
hit masks and prims equal, t to rtol 1e-3 where both hit, because the JAX
kernels take t from the Plücker num/den and the port from
Möller–Trumbore.  The CUDA kernels' own tests are in
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.mesh import procedural_dragon as j_dragon
from dod_raytracer_tpu.ops import traverse as jtrav
from dod_raytracer_tpu.ops.pallas import mt_kernel
from dod_raytracer_tpu_torch.mesh import load_mesh_asset, procedural_dragon
from dod_raytracer_tpu_torch.ops import forest, mega
from dod_raytracer_tpu_torch.ops import traverse as ttrav

N = 256
SHAPES = {
    # the teapot at the JAX tests' default shape: one table of < 1024 nodes
    "teapot": ("teapot", {}),
    # treelet_cap=128 cuts the teapot's tree into a real forest
    "teapot_cap128": ("teapot", dict(treelet_cap=128)),
    # JAX's own at-scale forest shape: > 1024 nodes, the production cut
    "dragon40k": ("dragon40k", dict(MaxPrims=32, leaf_chunk_lanes=32)),
}


def _mesh(name):
    if name == "dragon40k":
        tv, tn = procedural_dragon(num_tris=40000)
        np.testing.assert_array_equal(tv, j_dragon(num_tris=40000)[0])
        return tv, tn
    return load_mesh_asset(name)


@pytest.fixture(scope="module", params=list(SHAPES))
def pair(request):
    mesh, kw = SHAPES[request.param]
    tv, tn = _mesh(mesh)
    jb, tb = J.SceneBuilder(), T.SceneBuilder()
    for b in (jb, tb):
        b.add_mesh(tv, tn)
        b.add_light((0, 3, -3), 3.0)
    return request.param, tv, jb.build(J.Config(**kw)), tb.build(T.Config(**kw), device="cpu").kd, kw


def make_rays(tv, case, seed):
    """Half random rays in [-6, 6]^3, half aimed at random triangles; for
    'inside', origins near the mesh's center; for 'clipped', random t_max
    in [0, 8); the first 8 rays are dead (t_max = -1)."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((N, 3)) * 2 - 1) * 6.0).astype(np.float32)
    if case == "inside":
        o = (rng.random((N, 3)) * 0.5 - 0.25).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    aim = tv[rng.integers(0, tv.shape[0], N // 2)].mean(axis=1)
    d[: N // 2] = aim - o[: N // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full((N,), np.inf, np.float32)
    if case == "clipped":
        t_max = (rng.random(N) * 8.0).astype(np.float32)
    t_max[:8] = -1.0
    return o, d.astype(np.float32), t_max


def _jax(scene, o, d, t_max, backend, any_hit, kw):
    cfg = J.Config(traversal_backend=backend, **kw)
    args = (scene.kd, scene.triangles, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), cfg)
    if any_hit:
        return np.asarray(jtrav.kd_any(*args))
    return [np.asarray(x) for x in jtrav.kd_closest(*args)]


def _port(kd, o, d, t_max, backend, any_hit, kw):
    cfg = T.Config(traversal_backend=backend, **kw)
    args = (kd, None, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), cfg)
    if any_hit:
        return ttrav.kd_any(*args).numpy()
    return [x.numpy() for x in ttrav.kd_closest(*args)]


def _backend_of(name):
    """The walk each shape takes: forest where it has treelet tables."""
    return "mega" if name == "teapot" else "forest"


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_closest_matches_jax_kernel(pair, case):
    name, tv, jscene, tkd, kw = pair
    backend = _backend_of(name)
    o, d, t_max = make_rays(tv, case, seed=3)
    ref = _jax(jscene, o, d, t_max, backend, False, kw)
    got = _port(tkd, o, d, t_max, backend, False, kw)
    hit = ref[2]
    assert hit.sum() > N // 8  # the case has real hits to compare
    np.testing.assert_array_equal(got[2], hit)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-3)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])


@pytest.mark.parametrize("case", ["unclipped", "clipped"])
def test_any_hit_matches_jax_kernel(pair, case):
    name, tv, jscene, tkd, kw = pair
    backend = _backend_of(name)
    o, d, t_max = make_rays(tv, case, seed=5)
    t_max = np.where(t_max > 0, np.minimum(t_max, 5.0), t_max).astype(np.float32)
    ref = _jax(jscene, o, d, t_max, backend, True, kw)
    assert 0 < ref.sum() < N
    np.testing.assert_array_equal(_port(tkd, o, d, t_max, backend, True, kw), ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_forest_walk_gives_the_plain_walks_bits(pair, any_hit):
    name, tv, _, tkd, kw = pair
    if tkd.tre_tbl is None:
        with pytest.raises(ValueError):
            ttrav.traverse_forest_plain(tkd, *(torch.zeros((1, 3)),) * 2, torch.ones(1), 8, any_hit)
        return
    o, d, t_max = (torch.from_numpy(x) for x in make_rays(tv, "clipped", seed=7))
    depth = ttrav._stack_depth(tkd, T.Config(**kw))
    ref = ttrav.traverse_plain(tkd, o, d, t_max, depth, any_hit)
    got = ttrav.traverse_forest_plain(tkd, o, d, t_max, depth, any_hit)
    assert bool(ref[2].any())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_wrappers_on_cpu_count_no_launch(pair):
    name, tv, _, tkd, kw = pair
    o, d, t_max = (torch.from_numpy(x) for x in make_rays(tv, "unclipped", seed=9))
    depth = ttrav._stack_depth(tkd, T.Config(**kw))
    before = dict(mega.launches), dict(forest.launches)
    ref = ttrav.traverse_plain(tkd, o, d, t_max, depth, False)
    walks = [mega.mega_traverse] + ([forest.forest_traverse] if tkd.tre_tbl is not None else [])
    for walk in walks:
        for a, b in zip(walk(tkd, o, d, t_max, depth, False), ref):
            assert torch.equal(a, b)
    assert (dict(mega.launches), dict(forest.launches)) == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_per_ray_wrappers_on_cpu_count_no_launch(pair, any_hit):
    """``mega_traverse_per_ray`` and ``forest_traverse_per_ray`` on CPU
    tensors take the plain walks: their bits, and no launch counted."""
    name, tv, _, tkd, kw = pair
    o, d, t_max = (torch.from_numpy(x) for x in make_rays(tv, "clipped", seed=10))
    depth = ttrav._stack_depth(tkd, T.Config(**kw))
    counts = lambda: [dict(m.launches) for m in (mega, forest)] + [dict(m.per_ray_launches) for m in (mega, forest)]
    before = counts()
    ref = ttrav.traverse_plain(tkd, o, d, t_max, depth, any_hit)
    assert bool(ref[2].any())
    walks = [mega.mega_traverse_per_ray] + ([forest.forest_traverse_per_ray] if tkd.tre_tbl is not None else [])
    for walk in walks:
        for a, b in zip(walk(tkd, o, d, t_max, depth, any_hit), ref):
            assert torch.equal(a, b)
    assert counts() == before


def test_backend_resolves_as_jax(pair, monkeypatch):
    """Every name resolves as the JAX package resolves it on its
    accelerator, with and without the treelet tables; a name JAX does not
    know raises.  Without block_g or block_aabb the JAX package gives way
    to a slower walk; the port keeps the backend of the full tree, whose
    wrapper raises for CUDA tensors (tests/test_torch_cuda.py)."""
    _, _, jscene, tkd, _ = pair
    jkd = jscene.kd
    monkeypatch.setattr(mt_kernel, "on_tpu", lambda: True)
    kds = [(jkd, tkd)]
    if tkd.tre_tbl is not None:  # the same tree without its tables
        kds.append((jkd.replace(tre_tbl=None, top_tbl=None),
                    dataclasses.replace(tkd, tre_tbl=None, top_tbl=None)))
    for jk, tk in kds:
        for name in ("auto", "packet", "mega", "forest", "binned", "xla"):
            ref = jtrav._backend(jk, J.Config(traversal_backend=name))
            assert ttrav._backend(tk, T.Config(traversal_backend=name)) == ref, name
            for table in ("block_g", "block_aabb"):
                bare = dataclasses.replace(tk, **{table: None})
                assert ttrav._backend(bare, T.Config(traversal_backend=name)) == ref, (name, table)
    with pytest.raises(ValueError):
        ttrav._backend(tkd, T.Config(traversal_backend="gather"))
