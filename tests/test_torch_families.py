"""The families' any-hit door (``ops/families.py`` ``occluded_any``) on the
CPU: for CPU tensors it runs the plain version, the composition of the
port's sphere, plane and cylinder tests, and gives the JAX package's
``occluded_spheres | occluded_planes | occluded_cylinders`` bit for bit,
on the shadow wavefronts of a small teapot frame and on the hard rays of
``tests/torch_family_rays.py``; it never builds or loads the CUDA
library; ``families.lanes.any`` counts the lanes handed to it.  The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
import torch_family_rays as R
from dod_raytracer_tpu.ops import cylinder as jcyl
from dod_raytracer_tpu.ops import plane as jpl
from dod_raytracer_tpu.ops import sphere as jsp
from dod_raytracer_tpu.scene import Cylinders as JCylinders
from dod_raytracer_tpu.scene import Planes as JPlanes
from dod_raytracer_tpu.scene import Spheres as JSpheres
from dod_raytracer_tpu_torch import intersect
from dod_raytracer_tpu_torch.ops import _cuda, families
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
