"""The port's training loop and parameter checkpoints
(``dod_raytracer_tpu_torch.train``, ``.checkpoint``) vs the JAX package's
(``dod_raytracer_tpu.train``, ``.checkpoint``).

``tests/test_train.py``'s scene (24x24, 2 bounces, no kd tree): a sphere,
a plane and a light, with the sphere's albedo and the light's intensity
perturbed from the target's.  ``torch.optim.Adam`` with optax's defaults
computes optax's update, so the port's loss curve follows JAX's on the
same scene: each step's loss to rtol 1e-3 (over these 80 steps they
stay within about 2e-4 on the CPU; float32 rounding differs between the
packages, so they are not bit-equal).  A parameter file written by either package
restores in the other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import checkpoint as jckpt
from dod_raytracer_tpu import grad as jgrad
from dod_raytracer_tpu import train as jtrain
from dod_raytracer_tpu_torch import checkpoint as tckpt
from dod_raytracer_tpu_torch import grad as tgrad
from dod_raytracer_tpu_torch import train as ttrain

CFG = dict(Width=24, Height=24, use_kdtree=False, recursion_depth=2)
FIT_PARAMS = ("spheres.color", "lights.intensity")
FIT_STEPS = 80  # tests/test_train.py takes 150


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_scene(pkg, albedo, intensity):
    """tests/test_train.py's make_scene, in either package."""
    b = pkg.SceneBuilder()
    b.add_sphere((0.0, 0.0, 2.0), 1.2, albedo)
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), (0.3, 0.3, 0.6))
    b.add_light((1.0, 3.0, -2.0), intensity)
    if pkg is J:
        return b.build(J.Config(**CFG))
    return b.build(T.Config(**CFG), device="cpu")


def _target(albedo, intensity):
    """The target frame, rendered by JAX, as numpy."""
    return np.array(jgrad.render_for_grad(make_scene(J, albedo, intensity), J.Config(**CFG)))


def test_fit_recovers_albedo_and_light_as_jax_does():
    """tests/test_train.py:23-35 in 80 steps, next to JAX's fit on the same
    scene: every step's loss to rtol 1e-3 of JAX's, the fitted parameters
    to 1e-3 of JAX's, and both near the truth."""
    target = _target((0.8, 0.3, 0.2), 3.0)
    jfit, jlosses = jtrain.fit(make_scene(J, (0.4, 0.6, 0.5), 1.8), jnp.asarray(target), J.Config(**CFG),
                               params=FIT_PARAMS, steps=FIT_STEPS, lr=0.05, verbose=False)
    tfit, tlosses = ttrain.fit(make_scene(T, (0.4, 0.6, 0.5), 1.8), torch.from_numpy(target), T.Config(**CFG),
                               params=FIT_PARAMS, steps=FIT_STEPS, lr=0.05, verbose=False)
    assert len(tlosses) == FIT_STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    assert tlosses[-1] < tlosses[0] * 0.02, (tlosses[0], tlosses[-1])
    np.testing.assert_allclose(tfit.spheres.color.numpy(), np.asarray(jfit.spheres.color), atol=1e-3)
    np.testing.assert_allclose(tfit.lights.intensity.numpy(), np.asarray(jfit.lights.intensity), atol=1e-3)
    np.testing.assert_allclose(tfit.spheres.color[0].numpy(), [0.8, 0.3, 0.2], atol=0.05)
    assert abs(float(tfit.lights.intensity[0]) - 3.0) < 0.3


def test_fit_checkpoint_resume(tmp_path):
    """tests/test_train.py:37-52: a run of 20 steps with checkpoints every
    10, resumed to 40, runs only steps 20-39 and keeps descending.  The
    saved parameters and Adam state are float32 as they were, so the two
    halves give the losses of one uninterrupted 40-step run bit for bit."""
    target = torch.from_numpy(_target((0.7, 0.2, 0.5), 2.5))
    start = make_scene(T, (0.4, 0.4, 0.4), 2.0)
    ckpt = str(tmp_path / "fit.npz")
    cfg = T.Config(**CFG)
    _, l1 = ttrain.fit(start, target, cfg, steps=20, lr=0.05, checkpoint_path=ckpt, checkpoint_every=10,
                       verbose=False)
    _, l2 = ttrain.fit(start, target, cfg, steps=40, lr=0.05, checkpoint_path=ckpt, checkpoint_every=10,
                       verbose=False)
    assert len(l2) == 20
    assert l2[-1] <= l1[-1] * 1.05
    _, straight = ttrain.fit(start, target, cfg, steps=40, lr=0.05, verbose=False)
    assert l1 + l2 == straight


def _assert_same_params(a, b, params):
    for x, y in zip(tgrad.leaves(tgrad.split_float_params(a, params)),
                    tgrad.leaves(tgrad.split_float_params(b, params))):
        assert torch.equal(x, y)


CKPT_PARAMS = ("spheres", "lights", "planes.color")


def test_jax_params_file_restores_in_the_port(tmp_path):
    """A file of JAX's save_scene_params restores through the port's
    restore_scene_params: the same parameters, bit for bit, and the step."""
    path = str(tmp_path / "jax.npz")
    jckpt.save_scene_params(path, make_scene(J, (0.9, 0.2, 0.2), 7.5), params=CKPT_PARAMS, step=42)
    restored, opt_state, step = tckpt.restore_scene_params(path, make_scene(T, (0.1, 0.1, 0.1), 1.0),
                                                           params=CKPT_PARAMS)
    assert step == 42 and opt_state is None
    _assert_same_params(restored, make_scene(T, (0.9, 0.2, 0.2), 7.5), CKPT_PARAMS)


def test_port_params_file_restores_in_jax(tmp_path):
    """A file of the port's save_scene_params (with its optimizer state)
    restores through JAX's restore_scene_params, bit for bit."""
    path = str(tmp_path / "port.npz")
    scene = make_scene(T, (0.9, 0.2, 0.2), 7.5)
    opt = ttrain.make_optimizer(0.05)(tgrad.split_float_params(scene, CKPT_PARAMS))
    tckpt.save_scene_params(path, scene, params=CKPT_PARAMS, step=7, opt_state=opt.state_dict())
    restored, _, step = jckpt.restore_scene_params(path, make_scene(J, (0.1, 0.1, 0.1), 1.0), params=CKPT_PARAMS)
    assert step == 7
    ref = make_scene(J, (0.9, 0.2, 0.2), 7.5)
    for fam, field in (("spheres", "center"), ("spheres", "radius"), ("spheres", "color"), ("lights", "position"),
                       ("lights", "intensity"), ("planes", "color")):
        got, want = np.asarray(getattr(getattr(restored, fam), field)), np.asarray(getattr(getattr(ref, fam), field))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=f"{fam}.{field}")
    # and back into the port, optimizer state included
    back, opt_state, _ = tckpt.restore_scene_params(path, make_scene(T, (0.1, 0.1, 0.1), 1.0), params=CKPT_PARAMS,
                                                    opt_state_template=opt.state_dict())
    _assert_same_params(back, scene, CKPT_PARAMS)
    assert set(opt_state["state"]) == set(range(len(tgrad.leaves(tgrad.split_float_params(scene, CKPT_PARAMS)))))
