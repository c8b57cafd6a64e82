"""kd traversal: the port's plain walk vs the JAX package's XLA gather walk
(JAX ``traversal_backend="xla"``), and the packet wrapper's device dispatch.
The CUDA kernel's own test is ``tests/test_torch_cuda.py``.

Parity rules of the packet traversal (tests/test_packet.py): hit masks
agree, t agrees to rtol 1e-3 where both hit, and a prim may differ only
where both candidates' Möller–Trumbore t agree to rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.ops import traverse as jtrav
from dod_raytracer_tpu.render import _FrozenConfig
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.ops import packet
from dod_raytracer_tpu_torch.ops import traverse as ttrav

TREE_SHAPES = {"default": {}, "mp96_bl48": dict(MaxPrims=96, leaf_chunk_lanes=48)}
N = 1024


@pytest.fixture(scope="module", params=list(TREE_SHAPES))
def teapot_pair(request):
    kw = TREE_SHAPES[request.param]
    tv, tn = load_mesh_asset("teapot")
    jb, tb = J.SceneBuilder(), T.SceneBuilder()
    for b in (jb, tb):
        b.add_mesh(tv, tn)
        b.add_light((0, 3, -3), 3.0)
    jcfg = J.Config(traversal_backend="xla", **kw)
    tcfg = T.Config(**kw)
    return jb.build(jcfg), _FrozenConfig.from_config(jcfg), tb.build(tcfg, device="cpu"), tcfg


def make_rays(case, seed=0):
    """Half random rays in [-6, 6]^3, half aimed at random triangles
    (or, for 'inside', origins near the teapot's center)."""
    rng = np.random.default_rng(seed)
    tv, _ = load_mesh_asset("teapot")
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
    t_max[:16] = -1.0  # dead rays
    return o, d.astype(np.float32), t_max


def mt_t(verts, prim, o, d):
    """Möller–Trumbore t of triangle ``prim`` for each ray (numpy)."""
    tri = verts[prim]
    a, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = np.cross(d, e2)
    det = np.sum(e1 * p, axis=1)
    q = np.cross(o - a, e1)
    return np.sum(e2 * q, axis=1) / det


def assert_parity(verts, ref, got, o, d):
    (tr, pr, hr), (tg, pg, hg) = ref, got
    np.testing.assert_array_equal(hg, hr)
    np.testing.assert_allclose(tg[hr], tr[hr], rtol=1e-3)
    flip = hr & (pg != pr)
    if flip.any():
        np.testing.assert_allclose(mt_t(verts, pg[flip], o[flip], d[flip]),
                                   mt_t(verts, pr[flip], o[flip], d[flip]), rtol=1e-5)


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_plain_walk_matches_jax_closest(teapot_pair, case):
    jscene, jcfg, tscene, tcfg = teapot_pair
    o, d, t_max = make_rays(case)
    ref = jax.jit(jtrav.kd_closest, static_argnums=5)(
        jscene.kd, jscene.triangles, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jcfg)
    ref = [np.asarray(x) for x in ref]
    assert ref[2].sum() > N // 8  # the case has real hits to compare
    args = (tscene.kd, tscene.triangles, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max))
    got = [x.numpy() for x in ttrav.kd_closest(*args, tcfg)]
    assert_parity(np.asarray(tscene.triangles.verts), ref, got, o, d)
    # on CPU tensors the packet wrapper (the default backend) is the plain walk
    t, p, f = ttrav.traverse_plain(tscene.kd, *args[2:], ttrav._stack_depth(tscene.kd, tcfg), False)
    np.testing.assert_array_equal(got[0], t.numpy())
    np.testing.assert_array_equal(got[1], p.clamp_min(0).numpy())
    np.testing.assert_array_equal(got[2], (f & (t < args[4])).numpy())


@pytest.mark.parametrize("case", ["unclipped", "clipped"])
def test_plain_walk_matches_jax_any_hit(teapot_pair, case):
    jscene, jcfg, tscene, tcfg = teapot_pair
    o, d, t_max = make_rays(case, seed=1)
    t_max = np.where(t_max > 0, np.minimum(t_max, 5.0), t_max).astype(np.float32)
    ref = np.asarray(jax.jit(jtrav.kd_any, static_argnums=5)(
        jscene.kd, jscene.triangles, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jcfg))
    assert 0 < ref.sum() < N
    got = ttrav.kd_any(tscene.kd, tscene.triangles, torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(t_max), tcfg).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_xla_walk_matches_jax(teapot_pair, case):
    """traversal_backend="xla" on both packages: the gather walk with the
    barycentric Möller–Trumbore leaf test."""
    jscene, jcfg, tscene, tcfg = teapot_pair
    o, d, t_max = make_rays(case, seed=3)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    ref = [np.asarray(x) for x in jax.jit(jtrav.kd_closest, static_argnums=5)(
        jscene.kd, jscene.triangles, *args, jcfg)]
    assert ref[2].sum() > N // 8
    xcfg = dataclasses.replace(tcfg, traversal_backend="xla")
    targs = (tscene.kd, tscene.triangles, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max), xcfg)
    got = [x.numpy() for x in ttrav.kd_closest(*targs)]
    assert_parity(np.asarray(tscene.triangles.verts), ref, got, o, d)
    t_any = np.minimum(t_max, 5.0).astype(np.float32)
    ref_any = np.asarray(jax.jit(jtrav.kd_any, static_argnums=5)(
        jscene.kd, jscene.triangles, *args[:2], jnp.asarray(t_any), jcfg))
    got_any = ttrav.kd_any(*targs[:4], torch.from_numpy(t_any), xcfg).numpy()
    np.testing.assert_array_equal(got_any, ref_any)


def test_plain_walk_chunking_is_invisible(teapot_pair, monkeypatch):
    _, _, tscene, tcfg = teapot_pair
    o, d, t_max = (torch.from_numpy(x) for x in make_rays("clipped", seed=2))
    depth = ttrav._stack_depth(tscene.kd, tcfg)
    whole = ttrav.traverse_plain(tscene.kd, o, d, t_max, depth, False)
    monkeypatch.setattr(ttrav, "_PLAIN_CHUNK", 100)
    parts = ttrav.traverse_plain(tscene.kd, o, d, t_max, depth, False)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_packet_wrapper_on_cpu_counts_no_launch(teapot_pair):
    _, _, tscene, tcfg = teapot_pair
    o, d, t_max = (torch.from_numpy(x) for x in make_rays("unclipped", seed=3))
    before = dict(packet.launches)
    depth = ttrav._stack_depth(tscene.kd, tcfg)
    got = packet.packet_traverse(tscene.kd, o, d, t_max, depth, True)
    ref = ttrav.traverse_plain(tscene.kd, o, d, t_max, depth, True)
    np.testing.assert_array_equal(got[2].numpy(), ref[2].numpy())
    assert packet.launches == before


def test_default_stack_fits_the_packet_walk(teapot_pair):
    """The CUDA packet walk refuses a tree deeper than its stack; the
    default config never asks it to (the build's depth budget is far below
    64), while a shallower cfg.stack_depth still renders on the CPU, where
    the plain walk drops its deepest entry as the JAX kernels do."""
    _, _, tscene, tcfg = teapot_pair
    kd = tscene.kd
    assert 0 < kd.max_depth < T.Config().stack_depth
    assert ttrav._stack_depth(kd, T.Config()) > kd.max_depth
    o, d, t_max = (torch.from_numpy(x) for x in make_rays("unclipped", seed=5))
    shallow = dataclasses.replace(tcfg, stack_depth=kd.max_depth - 1)
    _, _, hit = ttrav.kd_closest(kd, tscene.triangles, o, d, t_max, shallow)
    assert bool(hit.any())


def test_backend_and_node_table(teapot_pair):
    _, _, tscene, tcfg = teapot_pair
    kd = tscene.kd
    for name in ("auto", "packet"):
        assert ttrav._backend(kd, T.Config(traversal_backend=name)) == "packet"
    # a tree of <= 1024 nodes without treelet tables: both per-ray walks
    # resolve to mega, as in the JAX package (tests/test_torch_walks.py
    # holds every name against the JAX dispatch)
    assert kd.tre_tbl is None
    for name in ("mega", "forest"):
        assert ttrav._backend(kd, T.Config(traversal_backend=name)) == "mega"
    for name in ("xla", "binned"):
        assert ttrav._backend(kd, T.Config(traversal_backend=name)) == name
    assert ttrav._stack_depth(kd, tcfg) == min(64, kd.max_depth + 1)
    tbl = ttrav._pack_nodes(kd)
    assert tbl.shape == (kd.node_flag.shape[0], 5) and tbl.is_contiguous()
    for col, field in enumerate(("node_flag", "node_split", "node_right", "node_leaf_start", "node_leaf_lanes")):
        ref = getattr(kd, field)
        np.testing.assert_array_equal(tbl[:, col].contiguous().view(ref.dtype).numpy(), ref.numpy())
