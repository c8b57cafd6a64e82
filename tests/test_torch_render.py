"""The port's integrator and shading vs the JAX package, and the render
entry point.

The reference frame is the JAX ``render_image`` executed op by op
(``jax.disable_jit``), with only the kd traversal compiled.  XLA's jit
contracts ``a * b + c`` into fused multiply-adds, which the op-by-op run,
numpy and PyTorch do not, and over 10 mirror bounces that alone moves
more of this frame's channels than the golden tolerance allows (jitted
vs op-by-op JAX on the same scene).  The traversal's outputs are triangle
ids and hit bits, so compiling it changes no shading arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import camera as jcam
from dod_raytracer_tpu import intersect as jint
from dod_raytracer_tpu import shading as jsh
from dod_raytracer_tpu.ops import traverse as jtrav
from dod_raytracer_tpu.render import _FrozenConfig
from dod_raytracer_tpu.utils.math import reflect as jreflect
from dod_raytracer_tpu_torch import intersect as tint
from dod_raytracer_tpu_torch import shading as tsh

FRAME = dict(Width=64, Height=32, MaxPrims=96, leaf_chunk_lanes=48, ray_tile=2048)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite's workers share the
    CPU, and the plain walks' many small multi-threaded ops slow down many
    times over when all workers' threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_golden_tolerance(img, ref):
    """tests/test_render_golden.py:49-54."""
    bad = np.abs(img - ref) > 2e-3
    assert bad.mean() < 0.01, f"{bad.mean():.4%} of channels off; max {np.abs(img - ref).max()}"
    q_port = T.quantize_u8(torch.from_numpy(img))
    q_ref = J.quantize_u8(jnp.asarray(ref))
    diff = (np.abs(q_port.astype(int) - q_ref.astype(int)) > 1).mean()
    assert diff < 0.01, f"u8 mismatch fraction {diff:.4%}"


_KD_CLOSEST = jax.jit(jtrav.kd_closest, static_argnums=5)
_KD_ANY = jax.jit(jtrav.kd_any, static_argnums=5)


def _compiled_kd_closest(*args):
    with jax.disable_jit(False):
        return _KD_CLOSEST(*args)


def _compiled_kd_any(*args):
    with jax.disable_jit(False):
        return _KD_ANY(*args)


@pytest.fixture(scope="module")
def op_by_op():
    """Run JAX op by op, except the kd traversal (compiled: see the module
    docstring)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrav, "kd_closest", _compiled_kd_closest)
        mp.setattr(jtrav, "kd_any", _compiled_kd_any)
        with jax.disable_jit():
            yield


def test_teapot_frame_matches_jax(op_by_op):
    jcfg = J.Config(**FRAME)
    jscene = J.default_scene(seed=0, cfg=jcfg, mesh="teapot").build(jcfg)
    ref = np.asarray(J.render_image(jscene, jcfg))

    tcfg = T.Config(**FRAME)
    tscene = T.default_scene(seed=0, cfg=tcfg, mesh="teapot").build(tcfg, device="cpu")
    img = T.render_image(tscene, tcfg, device="cpu")
    assert img.shape == (32, 64, 3) and torch.isfinite(img).all()
    assert_golden_tolerance(img.numpy(), ref)


@pytest.fixture(scope="module")
def default_pair():
    jcfg, tcfg = J.Config(**FRAME), T.Config(**FRAME)
    jscene = J.default_scene(seed=1, cfg=jcfg, mesh="teapot").build(jcfg)
    tscene = T.default_scene(seed=1, cfg=tcfg, mesh="teapot").build(tcfg, device="cpu")
    return jscene, _FrozenConfig.from_config(jcfg), tscene, tcfg


def test_bounce_step_matches_jax(default_pair, op_by_op):
    """Each bounce's closest hit, visibility and lighting factor, with
    both packages fed the same (JAX) rays."""
    jscene, jcfg, tscene, tcfg = default_pair
    closest, vis, factor = jint.closest_hit, jsh.light_visibility, jsh.lighting_factor
    o, d, raw = (np.asarray(x) for x in jcam.primary_rays(64, 32))
    active = np.ones(o.shape[0], bool)
    tt = lambda x: torch.from_numpy(np.array(x))
    for _ in range(4):
        t_max = np.where(active, np.inf, -1.0).astype(np.float32)
        jh = closest(jscene, jnp.asarray(o), jnp.asarray(d), jcfg, t_max=jnp.asarray(t_max))
        th = tint.closest_hit(tscene, tt(o), tt(d), tcfg, t_max=tt(t_max))
        mask = np.asarray(jh.mask)
        np.testing.assert_array_equal(th.mask.numpy(), mask)
        np.testing.assert_allclose(th.t.numpy()[mask], np.asarray(jh.t)[mask], rtol=1e-5)
        np.testing.assert_allclose(th.normal.numpy()[mask], np.asarray(jh.normal)[mask], atol=1e-5)
        np.testing.assert_array_equal(th.color.numpy()[mask], np.asarray(jh.color)[mask])
        active = active & mask
        p, nrm = np.asarray(jh.point), np.asarray(jh.normal)
        np.testing.assert_array_equal(
            tsh.light_visibility(tscene, tt(p), tcfg, tt(active)).numpy(),
            np.asarray(vis(jscene, jnp.asarray(p), jcfg, jnp.asarray(active))))
        jf = np.asarray(factor(jscene, jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(raw), jcfg,
                               jnp.asarray(active)))
        tf = tsh.lighting_factor(tscene, tt(p), tt(nrm), tt(raw), tcfg, tt(active)).numpy()
        np.testing.assert_allclose(tf, jf, rtol=1e-4)
        d_new = np.asarray(jreflect(jnp.asarray(d), jh.normal))
        o = np.where(active[:, None], p + d_new * np.float32(tcfg.Epsilon), o).astype(np.float32)
        d = np.where(active[:, None], d_new, d).astype(np.float32)


def test_shadow_batch_lights_same_bits(default_pair):
    _, _, tscene, tcfg = default_pair
    from dod_raytracer_tpu_torch.camera import primary_rays

    o, d, _ = primary_rays(64, 32, device="cpu")
    hit = tint.closest_hit(tscene, o, d, tcfg)
    per_light = tsh.light_visibility(tscene, hit.point, tcfg, hit.mask)
    batched = tsh.light_visibility(tscene, hit.point, T.Config(**FRAME, shadow_batch_lights=True), hit.mask)
    assert (~per_light).any()
    np.testing.assert_array_equal(batched.numpy(), per_light.numpy())


def test_block_ray_order_is_a_permutation():
    """Screen-block order (8x128 pixel packets) permutes the wavefront and
    puts it back; every ray's result is unchanged."""
    imgs = []
    for block in (False, True):
        cfg = T.Config(Width=128, Height=16, use_kdtree=False, ray_tile=4096, block_ray_order=block)
        scene = T.default_scene(seed=5, cfg=cfg, mesh=None).build(cfg, device="cpu")
        imgs.append(T.render_image(scene, cfg, device="cpu").numpy())
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_tiles_and_padding_match_one_tile():
    imgs = []
    for tile in (200, 4096):  # 31*17 = 527 rays: the 200-ray tiles pad the last one
        cfg = T.Config(Width=31, Height=17, use_kdtree=False, ray_tile=tile)
        scene = T.default_scene(seed=0, cfg=cfg, mesh=None).build(cfg, device="cpu")
        imgs.append(T.render_image(scene, cfg, device="cpu").numpy())
    np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-4)


def test_quantize_u8_matches():
    rng = np.random.default_rng(0)
    img = (rng.random((9, 7, 3)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(T.quantize_u8(torch.from_numpy(img)), J.quantize_u8(jnp.asarray(img)))


def test_unported_options_raise(default_pair):
    _, _, tscene, _ = default_pair
    from dod_raytracer_tpu_torch.camera import primary_rays

    o, d, raw = primary_rays(8, 4, device="cpu")
    # leaf-sharded triangles (parallel.leaf_shard) need a scene that carries the axis's process group
    with pytest.raises(ValueError, match="no process group"):
        T.render_rays(tscene, o, d, raw, T.Config(**FRAME, tri_shard_axis="mp"))
    with pytest.raises(ValueError):
        T.render_image(tscene, T.Config(**FRAME), device="cuda")  # the scene is on the CPU


def test_triangle_backend_does_not_change_a_kd_frame(default_pair):
    """triangle_backend is read only on the brute-force branch (the JAX
    package's intersect.py:54-70): with the kd tree, "pallas" and
    "plucker" render exactly the "jnp" frame (at 32x16 and 3 bounces, to
    keep the plain walks' many small ops few)."""
    _, _, tscene, _ = default_pair
    small = dict(FRAME, Width=32, Height=16, recursion_depth=3)
    ref = T.render_image(tscene, T.Config(**small), device="cpu")
    assert float(ref.mean()) > 0.01
    for backend in ("pallas", "plucker"):
        img = T.render_image(tscene, T.Config(**small, triangle_backend=backend), device="cpu")
        assert torch.equal(img, ref), backend
