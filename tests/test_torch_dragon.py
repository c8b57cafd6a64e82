"""The dragon: mesh, kd tables and a frame, the port vs the JAX package.

The mesh, the kd build and the treelet tables are host numpy in both
packages, so they must be bit-equal.  The flagship tree shape of
``bench.py`` (MaxPrims=192, leaf_chunk_lanes=48) is compared through the
``_kdtree_np`` functions, without the 481 MB ``block_g`` that
``build_kdtree`` would pack for 869,952 triangles; the whole ``KDArrays``
is compared on the JAX tests' own at-scale dragon (40,000 triangles,
MaxPrims=32, leaf_chunk_lanes=32, more than 1024 nodes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import mesh as jmesh
from dod_raytracer_tpu.accel import _kdtree_np as jnp_kd
from dod_raytracer_tpu_torch import mesh as tmesh
from dod_raytracer_tpu_torch.accel import _kdtree_np as tnp_kd
from dod_raytracer_tpu_torch.ops import traverse as ttrav
from dod_raytracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy
from test_torch_render import op_by_op  # noqa: F401  (a fixture)

FLAGSHIP = dict(MaxPrims=192, leaf_chunk_lanes=48)
AT_SCALE = dict(MaxPrims=32, leaf_chunk_lanes=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite's workers share the
    CPU, and the plain walks' many small multi-threaded ops slow down many
    times over when all workers' threads outnumber the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(obj):
    """A JAX scene's leaves (and static ints) as a nested dict."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, jnp.ndarray):
        return np.asarray(obj)
    return obj


def _assert_bit_equal(port, ref, path="scene"):
    assert isinstance(port, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        assert set(port) <= set(ref), path
        for k, v in port.items():
            _assert_bit_equal(v, ref[k], f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape, (path, port.shape, ref.shape)
        np.testing.assert_array_equal(port.view(np.uint8), ref.view(np.uint8), err_msg=path)
    else:
        assert port == ref, (path, port, ref)


def test_procedural_dragon_bit_equal():
    for a, b in zip(tmesh.procedural_dragon(num_tris=4096), jmesh.procedural_dragon(num_tris=4096)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_dragon_asset_bit_equal():
    tv, tn = tmesh.load_mesh_asset("dragon")
    jv, jn = jmesh.load_mesh_asset("dragon")
    assert tv.shape == (869_952, 3, 3)
    for a, b in ((tv, jv), (tn, jn)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_dragon_asset_without_cache_writes_nothing(tmp_path, monkeypatch):
    """Without the committed .npz the mesh is built in memory; nothing is
    written into the asset directory."""
    small = tmesh.procedural_dragon(num_tris=4096)
    monkeypatch.setattr(tmesh, "_ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(tmesh, "procedural_dragon", lambda: small)
    assert tmesh.load_mesh_asset("dragon") is small
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def flagship_built():
    tv, _ = tmesh.load_mesh_asset("dragon")
    kw = dict(lane_size=8, max_prims=FLAGSHIP["MaxPrims"], intersect_cost=80.0, traversal_cost=80.0,
              empty_bonus=0.0)
    lanes = FLAGSHIP["leaf_chunk_lanes"]
    return (tv, tnp_kd.align_leaves(tnp_kd.build(tv, **kw), lanes),
            jnp_kd.align_leaves(jnp_kd.build(tv, **kw), lanes), lanes)


def test_flagship_tree_tables_equal(flagship_built):
    """Node arrays, perm, treelet cut, treelet and top tables at bench.py's
    flagship shape (the JAX tables' columns, value for value)."""
    tv, tb, jb, lanes = flagship_built
    for f in ("node_flag", "node_split", "node_right", "node_leaf_start", "node_leaf_lanes",
              "bounds_min", "bounds_max", "prim_nums"):
        a, b = getattr(tb, f), getattr(jb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tb.max_leaf_lanes, tb.max_depth) == (jb.max_leaf_lanes, jb.max_depth)
    np.testing.assert_array_equal(tnp_kd.perm_from_prim_nums(tb.prim_nums, tv.shape[0], 8),
                                  jnp_kd.perm_from_prim_nums(jb.prim_nums, tv.shape[0], 8))
    assert tb.node_flag.shape[0] > 1024  # the forest's own case

    roots, sizes = tnp_kd.cut_treelets(tb, 1024)
    jroots, jsizes = jnp_kd.cut_treelets(jb, 1024)
    np.testing.assert_array_equal(roots, jroots)
    np.testing.assert_array_equal(sizes, jsizes)

    tre = tnp_kd.pack_treelet_tables(tb, roots, sizes, lanes, 1024)
    jtre = jnp_kd.pack_treelet_tables(jb, jroots, jsizes, lanes, 1024)
    assert tre.shape == (len(roots), 1024, 6) and jtre.shape == (len(roots), 1024, 128)
    for col, as_int in enumerate((True, False, True, True, True, True)):
        got = tre[..., col].view(np.int32).astype(np.float32) if as_int else tre[..., col]
        np.testing.assert_array_equal(got, jtre[..., col], err_msg=f"treelet column {col}")
    assert not jtre[..., 6:].any()

    top = tnp_kd.build_top_table(tb, roots)
    jtop = jnp_kd.build_top_table(jb, jroots)
    assert top.shape == (2 * len(roots) - 1, 4)
    for col, as_int in enumerate((True, False, True, True)):
        got = top[:, col].view(np.int32).astype(np.float32) if as_int else top[:, col]
        np.testing.assert_array_equal(got, jtop[: top.shape[0], col], err_msg=f"top column {col}")
    assert not jtop[top.shape[0]:].any() and not jtop[:, 4:].any()

    # the layout conversions the scene carries are exact both ways
    wide = tnp_kd.tables_to_jax(tre, top)
    for a, b in zip(wide, (jtre, jtop)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    for a, b in zip(tnp_kd.tables_from_jax(jtre, jtop), (tre, top)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.fixture(scope="module")
def at_scale_pair():
    tv, tn = tmesh.procedural_dragon(num_tris=40000)
    jb, tb = J.SceneBuilder(), T.SceneBuilder()
    for b in (jb, tb):
        b.add_mesh(tv, tn)
        b.add_light((0, 3, -3), 3.0)
    return jb.build(J.Config(**AT_SCALE)), tb.build(T.Config(**AT_SCALE), device="cpu")


def test_at_scale_kdarrays_bit_equal(at_scale_pair):
    """Every KDArrays field, block_g and the treelet tables included."""
    jscene, tscene = at_scale_pair
    assert tscene.kd.node_flag.shape[0] > 1024 and tscene.kd.tre_tbl is not None
    ref = _numpy(jscene)
    _assert_bit_equal(scene_to_numpy(tscene), ref)
    back = scene_from_numpy(ref, device="cpu")
    for f in ("tre_tbl", "top_tbl"):
        assert torch.equal(getattr(back.kd, f).view(torch.int32), getattr(tscene.kd, f).view(torch.int32))
    _assert_bit_equal(scene_to_numpy(back), ref)


def _off(img, ref):
    """(float channels off by > 2e-3, u8 channels off by > 1): the two
    halves of the golden tolerance (tests/test_render_golden.py:49-54)."""
    q_img = T.quantize_u8(torch.tensor(img))
    q_ref = J.quantize_u8(jnp.asarray(ref))
    return (float((np.abs(img - ref) > 2e-3).mean()),
            float((np.abs(q_img.astype(int) - q_ref.astype(int)) > 1).mean()))


# the float half of the bound per bounce depth: the golden 1% at 3
# bounces; at the recipe's 10, 3.1%, below the 3.14% of float channels on
# which JAX's own jitted frame is off its op-by-op frame (printed by the
# test; the port is off on 2.25%)
FLOAT_BOUND = {3: 0.01, 10: 0.031}


def check_small_dragon_forest_frame(depth):
    """The reference recipe with the 40k dragon, 64x32, through the port's
    forest backend (its plain forest walk on the CPU) vs JAX op by op with
    its gather walk ('xla'; the JAX tests hold forest equal to it).

    At 3 bounces the golden tolerance holds as it is.  At the recipe's 10
    the knotted tube of mirror triangles makes the paths chaotic: a one-ulp
    difference in a normal (XLA's CPU rsqrt is not correctly rounded,
    torch's is 1/sqrt) sends a ray elsewhere a few bounces later, and JAX's
    jitted frame is off its own op-by-op frame on more float channels than
    the golden 1%.  There the u8 half of the golden tolerance (< 1%) holds
    as it is, and the float half is capped at the fixed FLOAT_BOUND; the
    test prints JAX's own jit-vs-op-by-op fractions beside the port's.
    Run under the ``op_by_op`` fixture.
    """
    tv, tn = tmesh.procedural_dragon(num_tris=40000)
    frame = dict(Width=64, Height=32, ray_tile=2048, recursion_depth=depth, **AT_SCALE)
    jcfg = J.Config(traversal_backend="xla", **frame)
    tcfg = T.Config(traversal_backend="forest", **frame)
    jb = J.default_scene(seed=0, cfg=jcfg, mesh=None)
    tb = T.default_scene(seed=0, cfg=tcfg, mesh=None)
    for b in (jb, tb):
        b.add_mesh(tv, tn)
    jscene = jb.build(jcfg)
    ref = np.asarray(J.render_image(jscene, jcfg))
    tscene = tb.build(tcfg, device="cpu")
    assert ttrav._backend(tscene.kd, tcfg) == "forest"
    img = T.render_image(tscene, tcfg, device="cpu").numpy()
    assert img.shape == (32, 64, 3) and np.isfinite(img).all()
    port = _off(img, ref)
    print(f"depth {depth}: port vs JAX op by op {port}")
    if depth > 3:
        with jax.disable_jit(False):
            jitted = np.asarray(J.render_image(jscene, jcfg))
        print(f"depth {depth}: JAX jit vs op by op {_off(jitted, ref)}")
    assert port[0] < FLOAT_BOUND[depth], port
    assert port[1] < 0.01, port


# the 10-bounce case is in test_torch_dragon_frame.py: --dist loadfile
# then runs the two frames, the suite's longest tests, on two workers
@pytest.mark.parametrize("depth", [3])
def test_small_dragon_forest_frame_matches_jax(op_by_op, depth):
    """``check_small_dragon_forest_frame`` at 3 bounces."""
    check_small_dragon_forest_frame(depth)
