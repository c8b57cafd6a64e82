"""The port's frames against the numpy oracle and the JAX package's
``bounce_skip`` and ``shadow_reverse`` frames.

* The oracle (``dod_raytracer_tpu/oracle/renderer.py``, a per-pixel
  numpy renderer with no JAX in it) renders ``tests/test_render_golden.py``'s
  small scene; the port must match it by that file's golden rule
  (``:35-52``): under 1% of float channels off by more than 2e-3 and
  under 1% of u8 channels off by more than 1.
* ``bounce_skip`` on the open scene of ``:82-101`` (rays die at their
  first miss, so whole bounces are skipped): bit-equal to the port's frame
  without it, and to JAX's ``bounce_skip`` frame by the golden rule.
* ``shadow_reverse`` on ``:199-215``'s frame: against the port's forward
  frame, under 2% of pixels whose largest channel differs by more than
  1e-3 (that test's rule), and against JAX's reversed frame, run op by
  op (see ``tests/test_torch_render.py``), by the golden rule.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
import test_render_golden
from dod_raytracer_tpu.oracle import renderer as oracle
from dod_raytracer_tpu_torch import mesh as tmesh
from dod_raytracer_tpu_torch import render as trender
from test_torch_render import assert_golden_tolerance, op_by_op  # noqa: F401  (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_render_matches_oracle(monkeypatch):
    """tests/test_render_golden.py:35-52 at (24, 32), the port in JAX's place."""
    h, w = 24, 32
    # the JAX test's scene, built by the port's SceneBuilder (the same API
    # and host lists, which the oracle reads)
    monkeypatch.setattr(test_render_golden, "SceneBuilder", T.SceneBuilder)
    b = test_render_golden.build_small_scene()
    assert isinstance(b, T.SceneBuilder)
    cfg = T.Config(Width=w, Height=h, use_kdtree=False, ray_tile=1024)
    img = T.render_image(b.build(cfg, device="cpu"), cfg, device="cpu").numpy()
    ref = oracle.render(oracle.OracleScene.from_builder(b), w, h, eps=cfg.Epsilon, depth=cfg.recursion_depth)
    bad = np.abs(img - ref) > 2e-3
    assert bad.mean() < 0.01, f"{bad.mean():.4%} of channels off; max diff {np.abs(img - ref).max()}"
    q_port, q_ref = T.quantize_u8(torch.from_numpy(img)), oracle.quantize_u8(ref)
    diff = (np.abs(q_port.astype(int) - q_ref.astype(int)) > 1).mean()
    assert diff < 0.01, f"u8 mismatch fraction {diff:.4%}"


def open_scene(pkg, cfg):
    """tests/test_render_golden.py:91-97: the teapot, one sphere, one
    light, no walls."""
    tv, tn = tmesh.load_mesh_asset("teapot")  # JAX's bits (tests/test_torch_mesh_ply.py)
    b = pkg.SceneBuilder()
    b.add_mesh(tv, tn)
    b.add_sphere((2.5, 0.0, 1.0), 0.8, (0.9, 0.3, 0.2))
    b.add_light((0.0, 3.0, -3.0), 3.0)
    return b.build(cfg) if pkg is J else b.build(cfg, device="cpu")


def test_bounce_skip_open_scene(monkeypatch):
    frame = dict(Width=48, Height=32, use_kdtree=True, ray_tile=1536)
    tcfg = T.Config(**frame)
    scene = open_scene(T, tcfg)
    bounces = []
    step = trender._bounce
    monkeypatch.setattr(trender, "_bounce", lambda *a, **k: bounces.append(1) or step(*a, **k))
    plain = T.render_image(scene, tcfg, device="cpu")
    assert len(bounces) == tcfg.recursion_depth  # one tile
    bounces.clear()
    skipped = T.render_image(scene, dataclasses.replace(tcfg, bounce_skip=True), device="cpu")
    assert 0 < len(bounces) < tcfg.recursion_depth  # the last bounces were skipped
    assert float(plain.mean()) > 0.01
    assert torch.equal(skipped, plain)
    jcfg = J.Config(**frame, bounce_skip=True)
    ref = np.asarray(J.render_image(open_scene(J, jcfg), jcfg))
    assert_golden_tolerance(skipped.numpy(), ref)


@pytest.fixture(scope="module")
def reverse_frames():
    """tests/test_render_golden.py:199-215's frames in the port, forward
    and reversed."""
    frame = dict(Width=48, Height=24, use_kdtree=True, ray_tile=512, shadow_batch_lights=True)
    imgs = {}
    for rev in (False, True):
        cfg = T.Config(**frame, shadow_reverse=rev)
        scene = T.default_scene(seed=6, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
        imgs[rev] = T.render_image(scene, cfg, device="cpu").numpy()
    return frame, imgs


def test_shadow_reverse_near_identical(reverse_frames):
    _, imgs = reverse_frames
    diff = np.abs(imgs[False] - imgs[True]).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert frac < 0.02, f"{frac:.4f} of pixels differ beyond 1e-3"


def test_shadow_reverse_matches_jax(reverse_frames, op_by_op):
    frame, imgs = reverse_frames
    jcfg = J.Config(**frame, shadow_reverse=True)
    ref = np.asarray(J.render_image(J.default_scene(seed=6, cfg=jcfg, mesh="teapot").build(jcfg), jcfg))
    assert_golden_tolerance(imgs[True], ref)
