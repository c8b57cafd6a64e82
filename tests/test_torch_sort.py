"""The port's bounce and shadow sorts vs the JAX package.

``sort_bounces`` re-sorts the wavefront every bounce and ``sort_shadow``
each light's batched shadow rays, by the JAX package's ``_sort_keys``
(a direction bin over a Morton code of the origin).  Both are exact
permutations: on the CPU, where the per-ray plain walk runs, a sorted
frame equals the unsorted one bit for bit.  The keys must equal JAX's
bit for bit.  Frames are 32x16 at 2 bounces (1 where only the shadow
sort is tested): the plain walks run thousands of small torch ops per
frame, which slow badly when the suite's workers contend for the CPU.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import render as jrender
from dod_raytracer_tpu import shading as jsh
from dod_raytracer_tpu.render import _FrozenConfig
from dod_raytracer_tpu_torch import intersect as tint
from dod_raytracer_tpu_torch import render as trender
from dod_raytracer_tpu_torch import shading as tsh
from dod_raytracer_tpu_torch.camera import primary_rays
from dod_raytracer_tpu_torch.mesh import procedural_dragon
from test_torch_render import assert_golden_tolerance, op_by_op  # noqa: F401  (a fixture)

FRAME = dict(Width=32, Height=16, MaxPrims=96, leaf_chunk_lanes=48, ray_tile=512, recursion_depth=2,
             shadow_batch_lights=True)
BOUNCE_SORTS = {"origin_major": {}, "dir_major_kill_tail": {"sort_dir_major": True, "sort_kill_tail": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite's workers share the
    CPU, and the plain walks' parallel gathers slow down many times over
    when all workers' threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def teapot_pair():
    jcfg, tcfg = J.Config(**FRAME), T.Config(**FRAME)
    jscene = J.default_scene(seed=0, cfg=jcfg, mesh="teapot").build(jcfg)
    tscene = T.default_scene(seed=0, cfg=tcfg, mesh="teapot").build(tcfg, device="cpu")
    return jscene, tscene


@pytest.fixture(scope="module")
def teapot_unsorted(teapot_pair):
    """The teapot frame with both sorts off: the reference of every
    permutation test."""
    img = T.render_image(teapot_pair[1], T.Config(**FRAME, sort_bounces=False, sort_shadow=False), device="cpu")
    assert float(img.mean()) > 0.01
    return img


@pytest.fixture(scope="module")
def small_dragon():
    """The reference recipe with the 40k-triangle dragon (1,139 leaf
    blocks: the automatic rule sorts its shadows), at 1 bounce."""
    cfg = T.Config(**dict(FRAME, MaxPrims=32, leaf_chunk_lanes=32, recursion_depth=1))
    b = T.default_scene(seed=0, cfg=cfg, mesh=None)
    b.add_mesh(*procedural_dragon(40000))
    return cfg, b.build(cfg, device="cpu")


def _rays(seed, n=4096):
    """Origins inside and far outside the kd bounds, random directions,
    axis-parallel ones of either sign, and directions with a zero
    component."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * 12.0).astype(np.float32)
    o[: n // 4] *= 0.1
    d = rng.standard_normal((n, 3)).astype(np.float32)
    axis_rows = np.arange(64)
    d[axis_rows] = 0.0
    d[axis_rows, axis_rows % 3] = np.where(axis_rows % 2, 1.0, -1.0)
    d[64:128, 1] = 0.0
    d[128:192] = -np.abs(d[128:192])
    return o, d


def test_part1by2_matches_jax():
    v = np.arange(1024, dtype=np.int32)
    got = trender._part1by2(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrender._part1by2(jnp.asarray(v))))


@pytest.mark.parametrize("tree", [True, False])
def test_sort_keys_match_jax(teapot_pair, tree):
    jscene, tscene = teapot_pair
    if not tree:  # the [-6, 6] fallback bounds
        jscene, tscene = types.SimpleNamespace(kd=None), types.SimpleNamespace(kd=None)
    o, d = _rays(seed=1 + tree)
    got = trender._sort_keys(tscene, torch.from_numpy(o), torch.from_numpy(d))
    ref = np.asarray(jrender._sort_keys(jscene, jnp.asarray(o), jnp.asarray(d)))
    assert got.dtype == torch.int32 and ref.dtype == np.int32
    assert len(np.unique(ref)) > 1000
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", list(BOUNCE_SORTS))
def test_sort_bounces_frame_is_a_permutation(teapot_pair, teapot_unsorted, variant):
    """Each key variant re-sorts the wavefront and puts the colors back:
    the frame is the unsorted frame bit for bit."""
    _, tscene = teapot_pair
    img = T.render_image(tscene, T.Config(**FRAME, sort_bounces=True, sort_shadow=False, **BOUNCE_SORTS[variant]),
                         device="cpu")
    assert torch.equal(img, teapot_unsorted)


def test_sort_bounces_frame_matches_jax(teapot_pair, op_by_op):
    """The sorted frame against JAX's sorted frame, run op by op, with the
    same knobs (golden tolerance, tests/test_render_golden.py)."""
    jscene, tscene = teapot_pair
    knobs = dict(FRAME, sort_bounces=True, sort_kill_tail=True)
    ref = np.asarray(J.render_image(jscene, J.Config(**knobs)))
    img = T.render_image(tscene, T.Config(**knobs), device="cpu")
    assert_golden_tolerance(img.numpy(), ref)


@pytest.mark.parametrize("dir_major", [False, True])
def test_bounce_permutation_matches_jax(teapot_pair, dir_major):
    """The permutation itself, killed rays at the tail: a stable sort on
    JAX's key (JAX's sort_key_val is stable too), here with many equal
    keys."""
    jscene, tscene = teapot_pair
    o, d = _rays(seed=3)
    o[::2] = o[0]  # half the rays share an origin and direction bin
    d[::2] = d[0]
    active = np.arange(o.shape[0]) % 3 > 0
    cfg = T.Config(**FRAME, sort_kill_tail=True, sort_dir_major=dir_major)
    perm = trender._bounce_perm(tscene, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active), cfg)
    key = np.asarray(jrender._sort_keys(jscene, jnp.asarray(o), jnp.asarray(d)))
    if not dir_major:
        key = (key & ((1 << 21) - 1)) * (1 << 9) + (key >> 21)
    key = np.where(active, key, 1 << 30)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(key, kind="stable"))


def test_sort_shadow_frame_is_a_permutation_teapot(teapot_pair, teapot_unsorted):
    _, tscene = teapot_pair
    img = T.render_image(tscene, T.Config(**FRAME, sort_bounces=False, sort_shadow=True), device="cpu")
    assert torch.equal(img, teapot_unsorted)


def test_sort_shadow_frame_is_a_permutation_dragon(small_dragon):
    """The 40k dragon, sorted by the automatic rule, against the unsorted
    frame, bit for bit."""
    cfg, scene = small_dragon
    assert tsh._sort_shadow(scene, cfg)
    img = T.render_image(scene, cfg, device="cpu")
    ref = T.render_image(scene, dataclasses.replace(cfg, sort_shadow=False), device="cpu")
    assert float(ref.mean()) > 0.01
    assert torch.equal(img, ref)


def test_sort_shadow_visibility_matches_jax(teapot_pair):
    """Sorted batched shadow visibility of the primary hits against the
    JAX package's, bit for bit."""
    jscene, tscene = teapot_pair
    o, d, _ = primary_rays(32, 16, device="cpu")
    hit = tint.closest_hit(tscene, o, d, T.Config(**FRAME))
    knobs = dict(FRAME, sort_shadow=True)
    got = tsh.light_visibility(tscene, hit.point, T.Config(**knobs), hit.mask)
    ref = jsh.light_visibility(jscene, jnp.asarray(hit.point.numpy()), _FrozenConfig.from_config(J.Config(**knobs)),
                               jnp.asarray(hit.mask.numpy()))
    assert (~got).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sort_shadow_automatic_rule(teapot_pair, small_dragon):
    """None sorts over trees of 1,024 or more leaf blocks, on every device."""
    blocks = lambda b: types.SimpleNamespace(kd=types.SimpleNamespace(block_g=torch.empty((b, 0))))
    auto = T.Config()
    assert not tsh._sort_shadow(blocks(1023), auto)
    assert tsh._sort_shadow(blocks(1024), auto)
    assert not tsh._sort_shadow(types.SimpleNamespace(kd=None), auto)
    assert not tsh._sort_shadow(teapot_pair[1], auto)  # 38 blocks
    assert tsh._sort_shadow(small_dragon[1], auto)  # 1,139 blocks
    assert not tsh._sort_shadow(blocks(4096), T.Config(sort_shadow=False))
    assert tsh._sort_shadow(blocks(1), T.Config(sort_shadow=True))


def test_sort_bounces_default_by_device(teapot_pair, small_dragon):
    """None: on where the descend is the packet or the forest walk on CUDA
    tensors (the port's rule, from the H100 frames timed both ways), off
    on the CPU and for every other descend."""
    _, tscene = teapot_pair
    dscene = small_dragon[1]
    auto = T.Config()
    assert not trender._sort_bounces(tscene, auto, "cpu")
    assert trender._sort_bounces(tscene, auto, "cuda")
    assert trender._sort_bounces(tscene, T.Config(traversal_backend="packet"), "cuda")
    assert trender._sort_bounces(dscene, auto, "cuda")
    assert dscene.kd.tre_tbl is not None  # "forest" takes the forest walk there
    assert trender._sort_bounces(dscene, T.Config(traversal_backend="forest"), "cuda")
    assert not trender._sort_bounces(dscene, T.Config(traversal_backend="forest"), "cpu")
    for backend in ("mega", "forest", "binned", "xla"):  # "forest" on the teapot: the mega walk
        assert not trender._sort_bounces(tscene, T.Config(traversal_backend=backend), "cuda")
    for backend in ("mega", "binned", "xla"):  # "mega" on the dragon: the binned walk
        assert not trender._sort_bounces(dscene, T.Config(traversal_backend=backend), "cuda")
    assert not trender._sort_bounces(tscene, T.Config(brute_threshold=tscene.n_triangles), "cuda")
    assert not trender._sort_bounces(types.SimpleNamespace(kd=None, n_triangles=0), auto, "cuda")
    assert trender._sort_bounces(tscene, T.Config(sort_bounces=True), "cpu")
    assert not trender._sort_bounces(tscene, T.Config(sort_bounces=False), "cuda")


def _edge_distance(verts, o, d):
    """Barycentric distance from its nearest edge of the triangle each ray
    meets first (torch brute force; inf where it meets none)."""
    from dod_raytracer_tpu_torch.ops.triangle import brute_force_closest, mt_single

    t, idx = brute_force_closest(verts, o, d)
    hit = torch.isfinite(t)
    _, u, v = mt_single(verts[idx.long()], o, d, hit)
    near = torch.minimum(torch.minimum(u.abs(), v.abs()), (1.0 - u - v).abs())
    return torch.where(hit, near, float("inf"))


@pytest.mark.parametrize("knob", ["bounce_skip", "shadow_reverse"])
def test_knob_matches_jax(teapot_pair, teapot_unsorted, knob):
    """bounce_skip: the bounce-skipped sorted frame is the unsorted,
    unskipped frame bit for bit.  shadow_reverse: the batched visibility
    bits of the primary hits with reversed triangle rays, sorted and
    unsorted, equal each other and JAX's (``shadow_batch_lights``,
    ``shadow_reverse``) but on rays whose occluder is met within 1e-3
    (barycentric) of an edge, at most 0.1% of the pairs: there JAX's
    barycentric gather walk and the port's Plücker edge signs may
    disagree (ROADMAP.md Queue C 2)."""
    jscene, tscene = teapot_pair
    if knob == "bounce_skip":
        img = T.render_image(tscene, T.Config(**FRAME, sort_bounces=True, sort_shadow=True, bounce_skip=True),
                             device="cpu")
        assert torch.equal(img, teapot_unsorted)
        return
    o, d, _ = primary_rays(32, 16, device="cpu")
    hit = tint.closest_hit(tscene, o, d, T.Config(**FRAME))
    got = {srt: tsh.light_visibility(tscene, hit.point, T.Config(**FRAME, shadow_reverse=True, sort_shadow=srt),
                                     hit.mask) for srt in (False, True)}
    assert torch.equal(got[False], got[True])
    assert (~got[True]).any()
    jcfg = _FrozenConfig.from_config(J.Config(**FRAME, shadow_reverse=True))
    ref = torch.from_numpy(np.array(jsh.light_visibility(
        jscene, jnp.asarray(hit.point.numpy()), jcfg, jnp.asarray(hit.mask.numpy()))))
    differ = (got[True] != ref).T.reshape(-1)  # light-major, as the shadow wavefront
    if differ.any():
        so, sd, _ = tsh.shadow_rays(tscene, hit.point, hit.mask)
        ro, rd = tsh.reversed_rays(tscene, sd)
        near = _edge_distance(tscene.triangles.verts, ro[differ], rd[differ])
        assert bool((near < 1e-3).all()), near
    assert int(differ.sum()) <= np.ceil(1e-3 * differ.numel())
