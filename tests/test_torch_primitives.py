"""PyTorch port vs the JAX package: sphere, plane, cylinder and triangle
intersection, the slab test, on random rays made from a seed with numpy.

Hit masks must agree exactly and sphere, plane and cylinder t to rtol
1e-6: both sides compute the same float32 expressions, and only XLA's
approximate rsqrt or its fused multiply-adds move the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.ops import aabb as jaabb
from dod_raytracer_tpu.ops import cylinder as jcyl
from dod_raytracer_tpu.ops import plane as jpl
from dod_raytracer_tpu.ops import sphere as jsp
from dod_raytracer_tpu.ops import triangle as jtri
from dod_raytracer_tpu_torch.ops import aabb as taabb
from dod_raytracer_tpu_torch.ops import cylinder as tcyl
from dod_raytracer_tpu_torch.ops import plane as tpl
from dod_raytracer_tpu_torch.ops import sphere as tsp
from dod_raytracer_tpu_torch.ops import triangle as ttri

N = 4096
EPS = 1e-4


def rays(seed, spread=4.5):
    rng = np.random.default_rng(seed)
    o = ((rng.random((N, 3)) * 2 - 1) * spread).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(N) < 0.2, rng.random(N) * 6, np.inf).astype(np.float32)
    return o, d, t_max


def both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def scenes():
    cfg_j, cfg_t = J.Config(use_kdtree=False), T.Config(use_kdtree=False)
    jscene = J.default_scene(seed=3, cfg=cfg_j, mesh=None).build(cfg_j)
    tscene = T.default_scene(seed=3, cfg=cfg_t, mesh=None).build(cfg_t, device="cpu")
    return jscene, tscene


def assert_family_match(jh, th, t_max):
    jt, tt = np.asarray(jh.t), th.t.numpy()
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    assert hit.any()
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-6)
    np.testing.assert_allclose(th.normal.numpy()[hit], np.asarray(jh.normal)[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(th.color.numpy()[hit], np.asarray(jh.color)[hit])


@pytest.mark.parametrize("seed", [0, 1])
def test_spheres_match(scenes, seed):
    jscene, tscene = scenes
    (jo, jd, jt), (to, td, tt) = both(*rays(seed))
    jh = jsp.intersect_spheres(jscene.spheres, jo, jd, jt)
    th = tsp.intersect_spheres(tscene.spheres, to, td, tt)
    assert_family_match(jh, th, tt)
    np.testing.assert_array_equal(tsp.occluded_spheres(tscene.spheres, to, td, tt).numpy(),
                                  np.asarray(jsp.occluded_spheres(jscene.spheres, jo, jd, jt)))


@pytest.mark.parametrize("seed", [2, 3])
def test_planes_match(scenes, seed):
    jscene, tscene = scenes
    (jo, jd, jt), (to, td, tt) = both(*rays(seed))
    jh = jpl.intersect_planes(jscene.planes, jo, jd, jt, EPS)
    th = tpl.intersect_planes(tscene.planes, to, td, tt, EPS)
    assert_family_match(jh, th, tt)
    np.testing.assert_array_equal(tpl.occluded_planes(tscene.planes, to, td, tt, EPS).numpy(),
                                  np.asarray(jpl.occluded_planes(jscene.planes, jo, jd, jt, EPS)))


@pytest.mark.parametrize("color_bug", [False, True])
def test_cylinders_match(scenes, color_bug):
    jscene, tscene = scenes
    (jo, jd, jt), (to, td, tt) = both(*rays(4, spread=3.0))
    jh = jcyl.intersect_cylinders(jscene.cylinders, jo, jd, jt, EPS, color_bug=color_bug, n_valid=1)
    th = tcyl.intersect_cylinders(tscene.cylinders, to, td, tt, EPS, color_bug=color_bug, n_valid=1)
    assert_family_match(jh, th, tt)
    np.testing.assert_array_equal(
        tcyl.occluded_cylinders(tscene.cylinders, to, td, tt, EPS, n_valid=1).numpy(),
        np.asarray(jcyl.occluded_cylinders(jscene.cylinders, jo, jd, jt, EPS, n_valid=1)))


def test_padding_cylinder_never_hits():
    cfg = T.Config(use_kdtree=False)
    b = T.SceneBuilder()
    b.add_sphere((0.0, 0.0, 2.0), 1.0, (1.0, 0.0, 0.0))
    scene = b.build(cfg, device="cpu")
    _, (to, td, tt) = both(*rays(5))
    th = tcyl.intersect_cylinders(scene.cylinders, to, td, tt, EPS, n_valid=scene.n_cylinders)
    assert torch.isinf(th.t).all()


def test_slab_test_matches():
    o, d, t_max = rays(6, spread=8.0)
    d[:16, 0] = 0.0  # parallel to the x slabs
    o[:8, 0] = -2.5  # and on the slab face: NaN path of box.cpp:43-46
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    (jo, ji, jt), (to, ti, tt) = both(o, inv, t_max)
    bmin, bmax = np.array([-2.5, -1.0, -3.0], np.float32), np.array([2.0, 1.5, 3.0], np.float32)
    jr = jaabb.slab_test(jnp.asarray(bmin), jnp.asarray(bmax), jo, ji, jt)
    tr = taabb.slab_test(torch.from_numpy(bmin), torch.from_numpy(bmax), to, ti, tt)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def teapot():
    from dod_raytracer_tpu_torch.mesh import load_mesh_asset

    return load_mesh_asset("teapot")


def test_triangle_brute_force_and_attrs_match(teapot):
    tv, tn = teapot
    rng = np.random.default_rng(7)
    o = ((rng.random((512, 3)) * 2 - 1) * 4).astype(np.float32)
    aim = tv[rng.integers(0, tv.shape[0], 512)].mean(axis=1)  # rays aimed at triangles
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (jo, jd), (to, td) = both(o, d)
    jt, ji = jtri.brute_force_closest(jnp.asarray(tv), jo, jd)
    tt, ti = ttri.brute_force_closest(torch.from_numpy(tv), to, td)
    hit = np.isfinite(np.asarray(jt))
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    # rtol 1e-5, not 1e-6: the JAX brute force runs inside lax.scan, which
    # XLA compiles with fused multiply-adds, and Möller–Trumbore's
    # t = (AC . q) / det cancels, so a few ulps of an input become ~2e-6
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=1e-5)
    np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])

    cfg = T.Config(use_kdtree=False)
    b = T.SceneBuilder()
    b.add_mesh(tv, tn)
    tscene = b.build(cfg, device="cpu")
    jb = J.SceneBuilder()
    jb.add_mesh(tv, tn)
    jscene = jb.build(J.Config(use_kdtree=False))
    jh = jtri.triangle_hit_attrs(jscene.triangles, jo, jd, ji, jnp.asarray(hit), jscene.mesh_colors)
    th = ttri.triangle_hit_attrs(tscene.triangles, to, td, ti, torch.from_numpy(hit), tscene.mesh_colors)
    assert_family_match(jh, th, None)
    t_max = np.where(hit, np.asarray(jt) * 1.5, 2.0).astype(np.float32)
    np.testing.assert_array_equal(
        ttri.occluded_triangles_brute(torch.from_numpy(tv), to, td, torch.from_numpy(t_max)).numpy(),
        np.asarray(jtri.occluded_triangles_brute(jnp.asarray(tv), jo, jd, jnp.asarray(t_max))))
