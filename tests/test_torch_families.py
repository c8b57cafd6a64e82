"""The families' doors (``ops/families.py``) on the CPU.

The any-hit door ``occluded_any``: for CPU tensors it runs the plain
version, the composition of the port's sphere, plane and cylinder tests,
and gives the JAX package's ``occluded_spheres | occluded_planes |
occluded_cylinders`` bit for bit, on the shadow wavefronts of a small
teapot frame and on the hard rays of ``tests/torch_family_rays.py``; it
never builds or loads the CUDA library; ``families.lanes.any`` counts the
lanes handed to it.

The closest-hit door ``closest``: its plain version (the winner choice
``winner_plain``, then the winner's recompute ``hit_of``) equals the
family chain of ``intersect_spheres``, ``intersect_planes`` and
``intersect_cylinders`` bit for bit in t, and in the normal and colour of
every ray that hits, on the tie rays (whose winners are known), random
rays, rays clipped at their first hit and the teapot frame's wavefronts;
with gradients on, each of its three paths gives the chain's gradients
bit for bit; it agrees with the JAX package's chain as the per-family
tests do; ``families.lanes.closest`` and ``families.grad.rows`` count its
rows.  The kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
import torch_family_rays as R
from dod_raytracer_tpu.ops import cylinder as jcyl
from dod_raytracer_tpu.ops import plane as jpl
from dod_raytracer_tpu.ops import sphere as jsp
from dod_raytracer_tpu.ops.ray import closer as jcloser
from dod_raytracer_tpu.scene import Cylinders as JCylinders
from dod_raytracer_tpu.scene import Planes as JPlanes
from dod_raytracer_tpu.scene import Spheres as JSpheres
from dod_raytracer_tpu_torch import intersect
from dod_raytracer_tpu_torch.ops import _cuda, families
from dod_raytracer_tpu_torch.ops import cylinder as tcyl
from dod_raytracer_tpu_torch.ops import plane as tpl
from dod_raytracer_tpu_torch.ops import sphere as tsp
from dod_raytracer_tpu_torch.ops.ray import closer
from dod_raytracer_tpu_torch.utils import profiling

BOUNCES = (0, 3)  # the frame's shadow wavefronts compared


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_occluded(scene, o, d, t_max, eps):
    """The JAX package's family any-hit on the port scene's tables (numpy in)."""
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    blocked = jsp.occluded_spheres(JSpheres(a(sp.center), a(sp.radius), a(sp.color)), jo, jd, jt)
    blocked = blocked | jpl.occluded_planes(JPlanes(a(pl.point), a(pl.normal), a(pl.color)), jo, jd, jt, eps)
    cyl = JCylinders(a(cy.base), a(cy.axis), a(cy.radius), a(cy.height), a(cy.color))
    return np.asarray(blocked | jcyl.occluded_cylinders(cyl, jo, jd, jt, eps, n_valid=scene.n_cylinders))


def check_door(scene, o, d, t_max, eps, expected=None):
    """The door on CPU tensors: the plain version's bits, no launch, and
    the JAX package's bits -> the bits."""
    before = dict(families.launches)
    to, td, tt = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t_max))
    got = families.occluded_any(scene, to, td, tt, eps)
    assert got.dtype == torch.bool and got.shape == (o.shape[0],)
    assert torch.equal(got, families.occluded_plain(scene, to, td, tt, eps))
    assert families.launches == before
    np.testing.assert_array_equal(got.numpy(), jax_occluded(scene, o, d, t_max, eps))
    if expected is not None:
        np.testing.assert_array_equal(got.numpy(), expected)
    return got


@pytest.fixture(scope="module")
def teapot_wavefronts():
    """The shadow wavefronts (o, d, t_max, as numpy) that a 48x27 teapot-ref
    frame (config.ini, the teapot, the benchmark's kd shape; batched shadows)
    hands to ``occluded_families`` at bounces 0 and 3, and its scene."""
    cfg = T.Config.load("config.ini", Width=48, Height=27, recursion_depth=4, MaxPrims=96, leaf_chunk_lanes=48,
                        shadow_batch_lights=True)
    scene = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
    seen = []
    door = families.occluded_any

    def recording(scene, o, d, t_max, eps):
        seen.append(tuple(x.numpy().copy() for x in (o, d, t_max)))
        return door(scene, o, d, t_max, eps)

    mp = pytest.MonkeyPatch()
    mp.setattr(families, "occluded_any", recording)
    try:
        T.render_image(scene, cfg, device="cpu")
    finally:
        mp.undo()
    assert len(seen) == cfg.recursion_depth
    return scene, cfg, [seen[k] for k in BOUNCES]


@pytest.mark.parametrize("bounce", range(len(BOUNCES)))
def test_teapot_shadow_wavefront_matches_plain_and_jax(teapot_wavefronts, bounce):
    scene, cfg, fronts = teapot_wavefronts
    o, d, t_max = fronts[bounce]
    assert o.shape[0] == 48 * 27 * scene.lights.position.shape[0]
    assert (t_max < 0).any() and (t_max > 0).any()
    got = check_door(scene, o, d, t_max, cfg.Epsilon)
    assert 0 < int(got.sum()) < o.shape[0]


def test_hard_rays_give_the_known_bits():
    scene = R.hard_scene(T, device="cpu")
    o, d, t_max, expected = R.hard_rays()
    check_door(scene, o, d, t_max, R.EPS, expected)


@pytest.mark.parametrize("case", ["random", "at_hit"])
def test_random_rays_on_the_hard_scene(case):
    scene = R.hard_scene(T, device="cpu")
    o, d, t_max = R.random_rays(seed=7, n=4096)
    if case == "at_hit":
        t_first = R.first_hit_t(scene, torch.from_numpy(o), torch.from_numpy(d), R.EPS).numpy()
        assert np.isfinite(t_first).mean() > 0.3
        t_max = R.at_hit(t_first)
    got = check_door(scene, o, d, t_max, R.EPS)
    if case == "at_hit":
        hit = np.isfinite(t_first)
        # strictly before t_max: no ray is blocked at its first hit, and past it every ray is
        assert not got.numpy()[0::2][hit[0::2]].any() and got.numpy()[1::2][hit[1::2]].all()


def test_cpu_tensors_never_build_or_load_the_library(teapot_wavefronts, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(_cuda, "build", refuse)
    monkeypatch.setattr(_cuda, "library", refuse)
    scene, cfg, fronts = teapot_wavefronts
    o, d, t_max = (torch.from_numpy(x) for x in fronts[0])
    before = dict(families.launches)
    intersect.occluded_families(scene, o, d, t_max, cfg)
    T.render_image(scene, cfg, device="cpu")
    assert families.launches == before


def test_lanes_counter_counts_every_lane(teapot_wavefronts):
    scene, cfg, fronts = teapot_wavefronts
    o, d, t_max = (torch.from_numpy(x) for x in fronts[1])
    profiling.enable()
    try:
        families.occluded_any(scene, o, d, t_max, cfg.Epsilon)
        families.occluded_any(scene, o[:5], d[:5], t_max[:5], cfg.Epsilon)
    finally:
        profiling.disable()
    assert profiling.take()["counters"] == {"families.lanes.any": o.shape[0] + 5}


def test_door_refuses_other_devices():
    scene = R.hard_scene(T, device="cpu")
    o = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        families.occluded_any(scene, o, o, torch.zeros((2,), device="meta"), R.EPS)


# ---- the closest hit: ops/families.py closest ----

GEOMETRY = ("spheres.center", "spheres.radius", "planes.point", "planes.normal", "cylinders.base",
            "cylinders.axis", "cylinders.radius", "cylinders.height")
COLOURS = ("spheres.color", "planes.color", "cylinders.color")


def chain(scene, o, d, t_max, eps, color_bug):
    """The family chain as ``intersect.closest_families`` composed it
    before the door: each family's closest hit, clipped at the running t."""
    best = tsp.intersect_spheres(scene.spheres, o, d, t_max)
    best = closer(best, tpl.intersect_planes(scene.planes, o, d, torch.minimum(best.t, t_max), eps))
    return closer(best, tcyl.intersect_cylinders(scene.cylinders, o, d, torch.minimum(best.t, t_max), eps,
                                                 color_bug=color_bug, n_valid=scene.n_cylinders))


def check_closest(scene, o, d, t_max, eps, color_bug=False):
    """The plain version against the chain: t bit for bit on every ray,
    normal and colour on every ray that hits, the winner -1 exactly on the
    misses; the door without gradient gives the plain version's hit and
    launches nothing -> the winner codes."""
    o, d, t_max = (torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t_max))
    before = dict(families.launches)
    winner, got = families.closest_plain(scene, o, d, t_max, eps, color_bug)
    ref = chain(scene, o, d, t_max, eps, color_bug)
    hit = torch.isfinite(ref.t)
    assert winner.dtype == torch.int32 and torch.equal(winner >= 0, hit)
    assert torch.equal(got.t, ref.t)
    assert torch.equal(got.normal[hit], ref.normal[hit]) and torch.equal(got.color[hit], ref.color[hit])
    with torch.no_grad():
        door = families.closest(scene, o, d, t_max, eps, color_bug)
    assert all(torch.equal(getattr(door, k), getattr(got, k)) for k in ("t", "normal", "color"))
    assert families.launches == before
    return winner


def families_of(winner):
    """{(family, kind)} of the winners that hit (kind 0 but for cylinders)."""
    w = winner[winner >= 0]
    return set(zip((w & 3).tolist(), ((w >> 2) & 3).tolist()))


def scene_named(name):
    cfg = T.Config(use_kdtree=False)
    return {"hard": lambda: R.hard_scene(T, device="cpu"), "tie": lambda: R.tie_scene(T, device="cpu"),
            "many": lambda: R.many_scene(T, "cpu"),
            "default": lambda: T.default_scene(seed=3, cfg=cfg, mesh=None).build(cfg, device="cpu")}[name]()


@pytest.mark.parametrize("color_bug", [False, True])
def test_tie_rays_give_the_known_winners(color_bug):
    scene = R.tie_scene(T, device="cpu")
    o, d, t_max, code, t = R.tie_rays()
    winner = check_closest(scene, o, d, t_max, R.EPS, color_bug)
    np.testing.assert_array_equal(winner.numpy(), code)
    _, got = families.closest_plain(scene, *(torch.from_numpy(x) for x in (o, d, t_max)), R.EPS, color_bug)
    np.testing.assert_array_equal(got.t.numpy(), t)
    cyl = code >= 0
    cyl[cyl] = (code[cyl] & 3) == R.CYLINDER
    assert (got.color.numpy()[cyl] == 0).all() == color_bug


@pytest.mark.parametrize("case", ["random", "at_hit"])
@pytest.mark.parametrize("scene_name", ["hard", "tie", "many", "default"])
def test_plain_closest_equals_the_chain(scene_name, case):
    """Random rays (killed, clipped and unclipped), and rays clipped exactly
    at their first family hit and one ulp past it; on the hard scene every
    family and cylinder candidate wins somewhere, and its padded cylinder
    column never does."""
    scene = scene_named(scene_name)
    o, d, t_max = R.random_rays(seed=11, n=8192, spread=9.0 if scene_name == "many" else 6.0)
    if case == "at_hit":
        t_max = R.at_hit(R.first_hit_t(scene, torch.from_numpy(o), torch.from_numpy(d), R.EPS).numpy())
    winner = check_closest(scene, o, d, t_max, R.EPS)
    if scene_name == "hard":
        assert families_of(winner) == {(R.SPHERE, 0), (R.PLANE, 0), (R.CYLINDER, R.BODY),
                                       (R.CYLINDER, R.CAP_BASE), (R.CYLINDER, R.CAP_TOP)}
        cyl = winner[(winner >= 0) & ((winner & 3) == R.CYLINDER)]
        assert bool(((cyl >> 4) == 0).all())  # column 1 is past n_cylinders
    else:
        assert {f for f, _ in families_of(winner)} >= {R.SPHERE, R.PLANE}


@pytest.fixture(scope="module")
def teapot_closest_fronts():
    """The closest-hit queries (o, d, t_max, as numpy) that a 48x27
    teapot-ref frame hands to ``families.closest`` at bounces 0 and 3,
    and its scene."""
    cfg = T.Config.load("config.ini", Width=48, Height=27, recursion_depth=4, MaxPrims=96, leaf_chunk_lanes=48)
    scene = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
    seen = []
    door = families.closest

    def recording(scene, o, d, t_max, eps, color_bug):
        seen.append(tuple(x.numpy().copy() for x in (o, d, t_max)))
        return door(scene, o, d, t_max, eps, color_bug)

    mp = pytest.MonkeyPatch()
    mp.setattr(families, "closest", recording)
    try:
        T.render_image(scene, cfg, device="cpu")
    finally:
        mp.undo()
    assert len(seen) == cfg.recursion_depth
    return scene, cfg, [seen[k] for k in BOUNCES]


@pytest.mark.parametrize("bounce", range(len(BOUNCES)))
def test_teapot_closest_wavefront_equals_the_chain(teapot_closest_fronts, bounce):
    scene, cfg, fronts = teapot_closest_fronts
    o, d, t_max = fronts[bounce]
    assert o.shape[0] == 48 * 27
    winner = check_closest(scene, o, d, t_max, cfg.Epsilon, cfg.replicate_reference_bugs)
    assert {f for f, _ in families_of(winner)} >= {R.SPHERE, R.PLANE}  # the closed box: the walls catch the rest


def test_closest_agrees_with_the_jax_chain():
    """The door against the JAX package's family chain, by
    tests/test_torch_primitives.py's rule: hits equal, t to rtol 1e-6,
    normals to 1e-5, colours equal."""
    scene = scene_named("default")
    o, d, t_max = R.random_rays(seed=12, n=4096)
    with torch.no_grad():
        got = families.closest(scene, *(torch.from_numpy(x) for x in (o, d, t_max)), R.EPS, False)
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    sp, pl, cy = scene.spheres, scene.planes, scene.cylinders
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    best = jsp.intersect_spheres(JSpheres(a(sp.center), a(sp.radius), a(sp.color)), jo, jd, jt)
    best = jcloser(best, jpl.intersect_planes(JPlanes(a(pl.point), a(pl.normal), a(pl.color)), jo, jd,
                                              jnp.minimum(best.t, jt), R.EPS))
    cyl = JCylinders(a(cy.base), a(cy.axis), a(cy.radius), a(cy.height), a(cy.color))
    ref = jcloser(best, jcyl.intersect_cylinders(cyl, jo, jd, jnp.minimum(best.t, jt), R.EPS,
                                                 n_valid=scene.n_cylinders))
    hit = np.isfinite(np.asarray(ref.t))
    np.testing.assert_array_equal(np.isfinite(got.t.numpy()), hit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-6)
    np.testing.assert_allclose(got.normal.numpy()[hit], np.asarray(ref.normal)[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.color.numpy()[hit], np.asarray(ref.color)[hit])


def with_leaves(scene, names):
    """The scene with fresh copies of its family tables, those in ``names``
    leaves that require gradient."""
    new = {}
    for fam in ("spheres", "planes", "cylinders"):
        table = getattr(scene, fam)
        new[fam] = type(table)(**{f.name: getattr(table, f.name).detach().clone().requires_grad_(
            f"{fam}.{f.name}" in names) for f in dataclasses.fields(table)})
    return dataclasses.replace(scene, **new)


@pytest.mark.parametrize("color_bug", [False, True])
@pytest.mark.parametrize("case", ["geometry", "rays", "colour", "none"])
def test_gradients_equal_the_chains(case, color_bug):
    """Each path of the door against the chain, gradients on: the rays and
    every family table (``geometry``), the rays alone (``rays``), the
    colour tables alone (``colour``), nothing (``none``) requiring
    gradient.  A loss of t, normal and colour over the hits gives the
    chain's value and gradients bit for bit; the recompute's rows are
    counted on the geometry paths only."""
    scene = scene_named("default")
    names = {"geometry": GEOMETRY + COLOURS + ("o", "d"), "rays": ("o", "d"), "colour": COLOURS,
             "none": ()}[case]
    scene = with_leaves(scene, names)
    o, d, t_max = (torch.from_numpy(x) for x in R.random_rays(seed=13, n=4096, spread=4.0))
    o, d = o.requires_grad_("o" in names), d.requires_grad_("d" in names)
    leaves = [x for x in (o, d) if x.requires_grad] + [
        getattr(getattr(scene, n.split(".")[0]), n.split(".")[1]) for n in names if "." in n]
    rng = torch.Generator().manual_seed(5)
    w_t, w_n, w_c = torch.rand(4096, generator=rng), torch.rand(4096, 3, generator=rng), torch.rand(4096, 3,
                                                                                                    generator=rng)
    results = []
    for fn in (families.closest, chain):
        profiling.enable()
        try:
            hit = fn(scene, o, d, t_max, R.EPS, color_bug)
        finally:
            profiling.disable()
        counters = profiling.take()["counters"]
        mask = torch.isfinite(hit.t).detach()
        loss = ((torch.where(mask, hit.t, 0.0) * w_t).sum() + (hit.normal * w_n)[mask].sum()
                + (hit.color * w_c)[mask].sum())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True) if loss.requires_grad else ()
        results.append((loss.detach(), grads, counters))
    (loss, grads, counters), (ref_loss, ref_grads, _) = results
    assert torch.equal(loss, ref_loss) and len(grads) == len(ref_grads) == len(leaves)
    for g, r in zip(grads, ref_grads):
        assert (g is None) == (r is None)
        assert g is None or torch.equal(g, r)
    assert counters.get("families.grad.rows", 0) == (4096 if case in ("geometry", "rays") else 0)
    assert counters["families.lanes.closest"] == 4096
    if case == "colour":
        assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_closest_never_builds_or_loads_the_library_on_cpu_tensors(teapot_closest_fronts, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the CUDA library was asked for on CPU tensors")

    monkeypatch.setattr(_cuda, "build", refuse)
    monkeypatch.setattr(_cuda, "library", refuse)
    scene, cfg, fronts = teapot_closest_fronts
    o, d, t_max = (torch.from_numpy(x) for x in fronts[0])
    before = dict(families.launches)
    intersect.closest_families(scene, o, d, cfg, t_max)
    assert families.launches == before


def test_closest_door_refuses_other_devices():
    scene = R.hard_scene(T, device="cpu")
    o = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        families.closest(scene, o, o, torch.zeros((2,), device="meta"), R.EPS, False)
