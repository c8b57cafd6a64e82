"""The port's gradients (``dod_raytracer_tpu_torch.grad``, torch autograd)
vs the JAX package's (``dod_raytracer_tpu.grad``, ``jax.grad``).

Both packages build each scene from the same builder calls and numpy
arrays.  The JAX side is jitted (one compile per loss) and computed once
per module.  Frames are at most 24x24 with 1-4 bounces, and torch is
pinned to one intra-op thread: the plain walks run many small torch ops,
which slow badly when the suite's workers contend for the CPU.

Tolerances, each stated where it is used:

* scene-parameter grads (``tests/test_grad.py``'s small scene): port vs
  ``jax.grad`` to rtol 1e-3 (atol 1e-7) on the elements where JAX's own
  central differences are stable across two step sizes, by the filter of
  ``tests/test_grad.py:37-60``;
* vertex grads: the kd walk equal to brute force to rtol 1e-4 (atol
  1e-7, ``tests/test_grad.py:95-122``), and to JAX's kd vertex grads to
  rtol 1e-3 (atol 1e-6 of the largest grad).  The port's kd leaf test
  takes Plücker edge signs where JAX's gather walk takes barycentrics
  (Queue C 2 in ROADMAP.md): they can disagree on a ray within 1e-3 of a
  shared edge, which these scenes of separate random triangles do not
  have;
* ``remat_bounces`` on vs off: values to rtol 1e-5, grads equal to rtol
  1e-4 (atol 1e-6) on all but < 1e-3 of elements
  (``tests/test_grad.py:168-205``).

Ties: ``torch.clamp_min(x, 0)`` passes gradient 1 at ``x == 0`` where
JAX's ``jnp.maximum(0, x)`` passes 0.5; a difference there would sit on
an exact tie, which these frames do not meet.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import grad as jgrad
from dod_raytracer_tpu.ops import triangle as jtri
from dod_raytracer_tpu.grad import finite_difference as j_finite_difference
from dod_raytracer_tpu.render import _FrozenConfig
from dod_raytracer_tpu_torch import grad as tgrad
from dod_raytracer_tpu_torch.camera import primary_rays
from dod_raytracer_tpu_torch.ops import traverse as ttrav
from dod_raytracer_tpu_torch.ops import triangle as ttri

SMALL = dict(Width=24, Height=24, use_kdtree=False, recursion_depth=3)
# the small scene's parameters: (port/JAX leaf path, FD atol of tests/test_grad.py's check_fd)
SMALL_PARAMS = {"center": ("spheres.center", 2e-4), "radius": ("spheres.radius", 2e-4),
                "sphere_albedo": ("spheres.color", 1e-5), "light_intensity": ("lights.intensity", 1e-5),
                "plane_albedo": ("planes.color", 1e-5)}
FD_EPS = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module (see the module docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_builder(pkg):
    """``tests/test_grad.py``'s small_scene, in either package."""
    b = pkg.SceneBuilder()
    b.add_sphere((0.0, 0.3, 2.0), 1.1, (0.8, 0.3, 0.2))
    b.add_sphere((-1.5, -0.5, 3.5), 0.9, (0.2, 0.7, 0.3))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), (0.3, 0.3, 0.6))
    b.add_light((1.0, 3.0, -2.0), 3.0)
    b.add_light((-2.0, 2.0, 1.0), 1.5)
    return b


def _set_leaf(scene, path, value):
    fam, field = path.split(".")
    return scene.replace(**{fam: getattr(scene, fam).replace(**{field: value})})


def _get_leaf(scene, path):
    fam, field = path.split(".")
    return getattr(getattr(scene, fam), field)


@pytest.fixture(scope="module")
def jax_small():
    """JAX on the small scene: the target, the jitted grads of every
    parameter of SMALL_PARAMS, and the stable-FD filter of each."""
    cfg = _FrozenConfig.from_config(J.Config(**SMALL))
    scene = small_builder(J).build(cfg)
    target = np.asarray(jgrad.render_for_grad(scene, cfg)) * 0.8 + 0.02
    paths = [p for p, _ in SMALL_PARAMS.values()]

    def loss(vals):
        s = scene
        for path, v in zip(paths, vals):
            s = _set_leaf(s, path, v)
        return jgrad.mse_loss(s, jnp.asarray(target), cfg)

    p0 = [_get_leaf(scene, p) for p in paths]
    loss_j = jax.jit(loss)
    grads = [np.asarray(g, np.float64) for g in jax.jit(jax.grad(loss))(p0)]
    out = {"target": target, "loss": float(loss_j(p0))}
    for i, (name, (path, atol)) in enumerate(SMALL_PARAMS.items()):
        def f(x, i=i):
            return loss_j(p0[:i] + [x] + p0[i + 1:])
        fd1 = j_finite_difference(f, p0[i], eps=FD_EPS)
        fd2 = j_finite_difference(f, p0[i], eps=2 * FD_EPS)
        scale = np.maximum(np.abs(fd1), np.abs(fd2))
        out[name] = (grads[i], np.abs(fd1 - fd2) <= atol + 0.1 * scale)
    return out


@pytest.fixture(scope="module")
def port_small(jax_small):
    """The port's loss and grads on the same scene and target."""
    cfg = T.Config(**SMALL)
    scene = small_builder(T).build(cfg, device="cpu")
    target = torch.from_numpy(jax_small["target"])
    loss, grads = tgrad.loss_and_param_grads(scene, target, cfg, params=[p for p, _ in SMALL_PARAMS.values()])
    return scene, target, cfg, float(loss), grads


@pytest.mark.parametrize("name", list(SMALL_PARAMS))
def test_small_scene_grads_match_jax(jax_small, port_small, name):
    """Port vs jax.grad, rtol 1e-3 on the elements where JAX's FD is
    stable (at least half of them, as tests/test_grad.py demands)."""
    _, _, _, loss, grads = port_small
    np.testing.assert_allclose(loss, jax_small["loss"], rtol=1e-5)
    g_jax, smooth = jax_small[name]
    g = grads[SMALL_PARAMS[name][0]].numpy().astype(np.float64)
    assert smooth.mean() >= 0.5, f"only {smooth.mean():.0%} of FD elements stable"
    assert np.abs(g_jax).max() > 0
    bad = smooth & (np.abs(g - g_jax) > 1e-7 + 1e-3 * np.maximum(np.abs(g), np.abs(g_jax)))
    assert bad.sum() == 0, f"{bad.sum()} stable elements off\nport:\n{g}\njax:\n{g_jax}"


def test_sgd_step_lowers_loss_and_every_family_has_finite_grads(port_small):
    """tests/test_grad.py's TestInverseRendering: one SGD step on albedo and
    intensity lowers the loss; every family's grads are finite."""
    scene, target, cfg, _, _ = port_small
    val0, grads = tgrad.loss_and_param_grads(scene, target, cfg, params=("spheres", "lights"))
    val1, _ = tgrad.loss_and_param_grads(tgrad.sgd_step(scene, grads, lr=0.5), target, cfg,
                                         params=("spheres", "lights"))
    assert float(val1) < float(val0)
    families = ("spheres", "planes", "cylinders", "triangles", "mesh_colors", "lights")
    _, grads = tgrad.loss_and_param_grads(scene, target, cfg, params=families)
    assert set(grads) == set(families)
    assert grads["triangles"].mesh_id is None  # integer leaves are None
    for leaf in tgrad.leaves(grads):
        assert bool(torch.isfinite(leaf).all())


def _mesh_scene(pkg, backend_cfg, tris, normals):
    b = pkg.SceneBuilder()
    b.add_mesh(tris, normals, color=(0.6, 0.5, 0.4))
    b.add_light((0.0, 2.0, -3.0), 4.0)
    return b.build(backend_cfg) if pkg is J else b.build(backend_cfg, device="cpu")


MESH = dict(Width=16, Height=16, recursion_depth=2)


@pytest.fixture(scope="module")
def random_mesh():
    """tests/test_grad.py's 64 random triangles."""
    rng = np.random.default_rng(0)
    tris = (rng.standard_normal((64, 3, 3)) * 1.5).astype(np.float32)
    normals = np.tile(np.eye(3)[None, :, :], (64, 1, 1)).astype(np.float32)
    return tris, normals


def _port_vertex_grads(tris, normals, **cfg_kw):
    cfg = T.Config(**MESH, **cfg_kw)
    scene = _mesh_scene(T, cfg, tris, normals)
    _, grads = tgrad.loss_and_param_grads(scene, torch.zeros((16, 16, 3)), cfg, params=("triangles.verts",))
    return grads["triangles.verts"].numpy()


@pytest.fixture(scope="module")
def kd_vertex_grads(random_mesh):
    return _port_vertex_grads(*random_mesh, use_kdtree=True)


@pytest.mark.parametrize("backend", ["jnp", "pallas", "plucker"])
def test_vertex_grads_kd_equal_brute_force(random_mesh, kd_vertex_grads, backend):
    """tests/test_grad.py:95-122 on the port: the kd walk's vertex grads
    (its plain walk here) equal brute force's, through the torch brute
    force and the plain versions of both brute-force kernels."""
    brute = _port_vertex_grads(*random_mesh, use_kdtree=False, triangle_backend=backend)
    assert np.isfinite(brute).all() and np.abs(brute).max() > 0
    np.testing.assert_allclose(kd_vertex_grads, brute, rtol=1e-4, atol=1e-7)


def test_vertex_grads_match_jax_kd(random_mesh, kd_vertex_grads):
    """The port's kd vertex grads vs jax.grad through JAX's kd path."""
    tris, normals = random_mesh
    cfg = _FrozenConfig.from_config(J.Config(**MESH, use_kdtree=True))
    scene = _mesh_scene(J, cfg, tris, normals)

    def loss(v):
        s = scene.replace(triangles=scene.triangles.replace(verts=v))
        return jgrad.mse_loss(s, jnp.zeros((16, 16, 3)), cfg)

    g_jax = np.asarray(jax.jit(jax.grad(loss))(scene.triangles.verts))
    assert np.abs(g_jax).max() > 0
    np.testing.assert_allclose(kd_vertex_grads, g_jax, rtol=1e-3, atol=1e-6 * np.abs(g_jax).max())


def test_vertex_fd_small():
    """tests/test_grad.py:124-147 on the port's own finite_difference: a
    2-triangle mesh, every vertex coordinate, at most 20% of elements off
    by more than 3e-4 + 10%."""
    tris = np.asarray(
        [[[-1, -1, 2], [1, -1, 2], [0, 1, 2]],
         [[-2, -1, 3], [0.5, -1, 3.2], [-0.8, 1.2, 3.1]]], np.float32)
    normals = np.tile(np.asarray([0, 0, -1], np.float32), (2, 3, 1))
    cfg = T.Config(Width=16, Height=16, use_kdtree=False, recursion_depth=1)
    b = T.SceneBuilder()
    b.add_mesh(tris, normals, color=(0.7, 0.6, 0.2))
    b.add_light((0.0, 0.0, -3.0), 5.0)
    scene = b.build(cfg, device="cpu")
    target = torch.zeros((16, 16, 3))

    def loss(v):
        return tgrad.mse_loss(tgrad.merge_params(scene, {"triangles.verts": v}), target, cfg)

    _, grads = tgrad.loss_and_param_grads(scene, target, cfg, params=("triangles.verts",))
    g = grads["triangles.verts"].numpy().astype(np.float64)
    fd = tgrad.finite_difference(loss, scene.triangles.verts, eps=2e-3)
    denom = np.maximum(np.abs(fd), np.abs(g))
    bad = np.abs(g - fd) > (3e-4 + 0.1 * denom)
    assert np.abs(g).max() > 0
    assert bad.mean() <= 0.2, f"{bad.mean():.2%}\n{g}\n{fd}"


def test_remat_bounces_values_and_grads(monkeypatch):
    """remat_bounces changes what the backward keeps, not the result: at
    24x16 with 4 bounces (the teapot, kd walk) the values agree to rtol
    1e-5 and the vertex grads by tests/test_grad.py:168-205's rule.  The
    recompute reads the traversal outputs back: the backward calls no walk."""
    calls = {"n": 0}
    walk = ttrav._traverse

    def counting(*args, **kw):
        calls["n"] += 1
        return walk(*args, **kw)

    monkeypatch.setattr(ttrav, "_traverse", counting)
    base = dict(Width=24, Height=16, recursion_depth=4, MaxPrims=96, leaf_chunk_lanes=48)
    scene = T.default_scene(seed=3, cfg=T.Config(**base), mesh="teapot", num_spheres=4).build(
        T.Config(**base), device="cpu")
    o, d, d_raw = primary_rays(24, 16, device="cpu")

    def value_and_grad(remat):
        verts = scene.triangles.verts.detach().clone().requires_grad_(True)
        s = tgrad.merge_params(scene, {"triangles.verts": verts})
        calls["n"] = 0
        val = torch.sum(T.render_rays(s, o, d, d_raw, T.Config(**base, remat_bounces=remat)) ** 2)
        forward = calls["n"]
        val.backward()
        assert forward == 4 * (1 + scene.n_lights) and calls["n"] == forward, (remat, forward, calls["n"])
        return float(val.detach()), verts.grad.numpy()

    v0, g0 = value_and_grad(False)
    v1, g1 = value_and_grad(True)
    np.testing.assert_allclose(v0, v1, rtol=1e-5)
    assert np.abs(g0).max() > 0
    close = np.isclose(g0, g1, rtol=1e-4, atol=1e-6)
    assert 1.0 - close.mean() < 1e-3, f"{1.0 - close.mean():.2e} of grad elements differ"
    assert np.abs(g0 - g1).sum() / max(np.abs(g0).sum(), 1e-9) < 1e-3


def test_remat_forward_keeps_few_python_objects():
    """A remat_bounces forward leaves no shape record of each tensor a
    bounce saves (the checkpoint's determinism check, which kept a dict
    and a ``Size`` of each until the backward, and so some 700 objects a
    bounce here, for the garbage collector's full passes to walk): at
    24x16 with 4 bounces, fewer than 500 objects a bounce outlive the
    forward (about 340), and none the backward."""
    base = dict(Width=24, Height=16, recursion_depth=4, MaxPrims=96, leaf_chunk_lanes=48, remat_bounces=True)
    scene = T.default_scene(seed=3, cfg=T.Config(**base), mesh="teapot", num_spheres=4).build(
        T.Config(**base), device="cpu")
    o, d, d_raw = primary_rays(24, 16, device="cpu")
    kept = []
    for _ in range(2):  # the first pass also imports and caches
        verts = scene.triangles.verts.detach().clone().requires_grad_(True)
        s = tgrad.merge_params(scene, {"triangles.verts": verts})
        gc.collect()
        n0 = len(gc.get_objects())
        val = torch.sum(T.render_rays(s, o, d, d_raw, T.Config(**base)) ** 2)
        gc.collect()
        n1 = len(gc.get_objects())
        val.backward()
        del val
        gc.collect()
        kept.append((n1 - n0, len(gc.get_objects()) - n0))
    assert verts.grad is not None and float(verts.grad.abs().max()) > 0
    assert kept[-1][0] < 500 * base["recursion_depth"] and kept[-1][1] <= 0, kept


def test_merge_params_refreshes_blocks_like_jax():
    """An update of 'triangles.verts' that keeps every triangle inside its
    lane's filing box (``merge_params``, then the kd upkeep after a step,
    ``follow_moves``) keeps the tree and refreshes the kd leaf blocks:
    equal bit for bit to JAX's merge_params of the same vertices."""
    kw = dict(MaxPrims=96, leaf_chunk_lanes=48)
    jscene = J.default_scene(seed=0, cfg=J.Config(**kw), mesh="teapot", num_spheres=1).build(J.Config(**kw))
    tscene = T.default_scene(seed=0, cfg=T.Config(**kw), mesh="teapot", num_spheres=1).build(
        T.Config(**kw), device="cpu")
    # each triangle shrunk towards its centroid, clipped to its own box
    v0 = np.asarray(jscene.triangles.verts).astype(np.float64)
    c = v0.mean(axis=1, keepdims=True)
    verts = np.clip((c + 0.9 * (v0 - c)).astype(np.float32), v0.min(axis=1, keepdims=True).astype(np.float32),
                    v0.max(axis=1, keepdims=True).astype(np.float32))
    jkd = jgrad.merge_params(jscene, {"triangles.verts": jnp.asarray(verts)}).kd
    tkd = tgrad.follow_moves(tscene, tgrad.merge_params(tscene, {"triangles.verts": torch.from_numpy(verts)})).kd
    assert tkd.node_split is tscene.kd.node_split  # no rebuild
    for f in ("block_tris", "block_g", "block_aabb"):
        port, ref = getattr(tkd, f).numpy(), np.asarray(getattr(jkd, f))
        assert not np.array_equal(port, getattr(tscene.kd, f).numpy()), f
        np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32), err_msg=f)


def test_split_and_merge_params_round_trip():
    """split_float_params gives JAX's structure (families whole, dotted
    leaves alone, integer leaves None); merge_params of it is the scene."""
    cfg = T.Config(use_kdtree=False)
    scene = T.default_scene(seed=0, cfg=cfg, mesh=None, num_spheres=2).build(cfg, device="cpu")
    diff = tgrad.split_float_params(scene, ("spheres", "triangles", "lights.intensity", "mesh_colors"))
    assert isinstance(diff["spheres"], type(scene.spheres)) and diff["triangles"].mesh_id is None
    assert diff["lights.intensity"] is scene.lights.intensity and diff["mesh_colors"] is scene.mesh_colors
    back = tgrad.merge_params(scene, diff)
    assert back.triangles.mesh_id is scene.triangles.mesh_id
    assert back.lights.intensity is scene.lights.intensity and back.spheres.center is scene.spheres.center
    with pytest.raises(AssertionError):
        tgrad.merge_params(scene, {"spheres.color": scene.spheres.color, "spheres": diff["spheres"]})


def test_brute_force_records_no_graph_on_the_rays(monkeypatch):
    """The brute-force winner search runs without gradient on the vertices
    and the rays (JAX's stop_gradient, intersect.py:58-60,86); the hit it
    returns is recomputed with gradient, and equals JAX's."""
    search = ttri.brute_force_closest

    def no_graph(verts, o, d, chunk):
        assert not torch.is_grad_enabled()
        assert not (verts.requires_grad or o.requires_grad or d.requires_grad)
        return search(verts, o, d, chunk)

    monkeypatch.setattr(ttri, "brute_force_closest", no_graph)
    rng = np.random.default_rng(3)
    tv = (rng.standard_normal((40, 3, 3))).astype(np.float32)
    tn = np.tile(np.eye(3)[None], (40, 1, 1)).astype(np.float32)
    o = np.zeros((64, 3), np.float32) - np.asarray([0, 0, 4], np.float32)
    d = rng.standard_normal((64, 3)).astype(np.float32) * 0.3 + np.asarray([0, 0, 1], np.float32)
    t_max = np.full((64,), np.inf, np.float32)
    tris = T.scene.Triangles(torch.from_numpy(tv).requires_grad_(True), torch.from_numpy(tn),
                             torch.zeros((40,), dtype=torch.int32))
    to, td = torch.from_numpy(o).requires_grad_(True), torch.from_numpy(d).requires_grad_(True)
    fh = ttri.intersect_triangles_brute(tris, torch.ones((1, 3)), to, td, torch.from_numpy(t_max), chunk=16)
    jfh = jtri.intersect_triangles_brute(
        J.scene.Triangles(jnp.asarray(tv), jnp.asarray(tn), jnp.zeros((40,), jnp.int32)), jnp.ones((1, 3)),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), chunk=16)
    hit = np.isfinite(np.asarray(jfh.t))
    assert hit.any()
    np.testing.assert_array_equal(np.isfinite(fh.t.detach().numpy()), hit)
    np.testing.assert_allclose(fh.t.detach().numpy()[hit], np.asarray(jfh.t)[hit], rtol=1e-6)
    torch.sum(torch.where(torch.isfinite(fh.t), fh.t, 0.0)).backward()
    assert tris.verts.grad is not None and to.grad is not None and td.grad is not None
