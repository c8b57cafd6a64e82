"""PyTorch port vs the JAX package: configuration, scene assembly, kd-tree
tables, camera rays, mesh loading and PNG output.

Scene assembly and the kd build are host numpy in both packages, and the
block tables are elementwise products, so every array must be bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import camera as jcam
from dod_raytracer_tpu import mesh as jmesh
from dod_raytracer_tpu.config import _parse_ini as j_parse_ini
from dod_raytracer_tpu.io import read_png
from dod_raytracer_tpu_torch import camera as tcam
from dod_raytracer_tpu_torch import mesh as tmesh
from dod_raytracer_tpu_torch.config import _parse_ini as t_parse_ini
from dod_raytracer_tpu_torch.io import write_png
from dod_raytracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy

TREE_SHAPES = {"default": {}, "mp96_bl48": dict(MaxPrims=96, leaf_chunk_lanes=48)}


def jax_to_numpy(obj):
    """The JAX Scene's leaves (and static ints) as a nested dict."""
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, jnp.ndarray):
        return np.asarray(obj)
    return obj


def assert_bit_equal(port, ref, path="scene"):
    """Every entry of ``port`` (nested dict) equals ``ref`` bit for bit."""
    assert isinstance(port, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        for k, v in port.items():
            assert k in ref, f"{path}.{k} has no JAX counterpart"
            assert_bit_equal(v, ref[k], f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape, (path, port.dtype, ref.dtype)
        np.testing.assert_array_equal(port.view(np.uint8), ref.view(np.uint8), err_msg=path)
    else:
        assert port == ref, (path, port, ref)


@pytest.fixture(scope="module", params=list(TREE_SHAPES))
def teapot_pair(request):
    kw = TREE_SHAPES[request.param]
    jscene = J.default_scene(seed=0, cfg=J.Config(**kw), mesh="teapot").build(J.Config(**kw))
    tscene = T.default_scene(seed=0, cfg=T.Config(**kw), mesh="teapot").build(T.Config(**kw), device="cpu")
    return jscene, tscene


def test_scene_leaves_bit_equal(teapot_pair):
    """Every Scene leaf and every KDArrays field, teapot at both tree shapes
    (but the tree's filing boxes and build Config, the port's own, which
    the JAX package has not)."""
    jscene, tscene = teapot_pair
    port = scene_to_numpy(tscene)
    ref = jax_to_numpy(jscene)
    assert_bit_equal(port, ref)
    kd_fields = {f.name for f in dataclasses.fields(T.scene.KDArrays)} - set(T.scene.TREE_FILING)
    assert kd_fields <= set(ref["kd"])
    assert tscene.kd.lane_lo is not None
    assert port["kd"]["block_g"] is not None and port["kd"]["block_aabb"] is not None


def test_scene_from_numpy_round_trip(teapot_pair):
    jscene, _ = teapot_pair
    arrays = jax_to_numpy(jscene)
    scene = scene_from_numpy(arrays, device="cpu")
    assert isinstance(scene.kd.block_g, torch.Tensor) and scene.kd.block_g.device.type == "cpu"
    assert_bit_equal(scene_to_numpy(scene), arrays)


def test_mesh_free_scene_bit_equal():
    cfg_j, cfg_t = J.Config(), T.Config()
    jscene = J.default_scene(seed=7, cfg=cfg_j, mesh=None, with_cylinder=False).build(cfg_j)
    tscene = T.default_scene(seed=7, cfg=cfg_t, mesh=None, with_cylinder=False).build(cfg_t, device="cpu")
    assert tscene.kd is None
    assert_bit_equal(scene_to_numpy(tscene), jax_to_numpy(jscene))


def test_default_scene_defaults_to_the_dragon():
    """default_scene with no mesh gives the dragon in both packages (the
    JAX package's default, scene.py:280-281): equal arrays, built without
    the kd tree."""
    cfg_j, cfg_t = J.Config(use_kdtree=False), T.Config(use_kdtree=False)
    jscene = J.default_scene(seed=0).build(cfg_j)
    tscene = T.default_scene(seed=0).build(cfg_t, device="cpu")
    assert tscene.n_triangles == jscene.n_triangles == tmesh.load_mesh_asset("dragon")[0].shape[0]
    assert_bit_equal(scene_to_numpy(tscene), jax_to_numpy(jscene))


def test_config_keys_defaults_and_ini(tmp_path):
    jf = {f.name: f.default for f in dataclasses.fields(J.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(T.Config)}
    assert jf == tf
    ini = tmp_path / "c.ini"
    ini.write_text("Width: 320\nHeight : 200\nnot a pair\nMaxPrims: 96\nUnknown: 1\nuse_kdtree: false\n")
    assert t_parse_ini(str(ini)) == j_parse_ini(str(ini))
    assert dataclasses.asdict(T.Config.load(str(ini), ray_tile=0)) == \
        dataclasses.asdict(J.Config.load(str(ini), ray_tile=0))
    with pytest.raises(KeyError):
        T.Config.load(None, NoSuchKey=1)


@pytest.mark.parametrize("w,h,rows", [(64, 32, None), (1920, 1080, (8, 16))])
def test_primary_rays_match(w, h, rows):
    r0, r1 = rows or (0, None)
    jo, jd, jr = jcam.primary_rays(w, h, r0, r1)
    to, td, tr = tcam.primary_rays(w, h, r0, r1, device="cpu")
    for a, b in ((jo, to), (jd, td), (jr, tr)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_mesh_pipeline_matches():
    v, f, vn = tmesh.load_obj(tmesh.os.path.join(tmesh._ASSET_DIR, "teapot.obj"))
    jv, jf, jvn = jmesh.load_obj(jmesh.os.path.join(jmesh._ASSET_DIR, "teapot.obj"), use_native=False)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert vn is None and jvn is None
    np.testing.assert_array_equal(tmesh.smooth_normals(v, f), jmesh.smooth_normals(jv, jf))
    for a, b in zip(tmesh.load_mesh_asset("teapot"), jmesh.load_mesh_asset("teapot")):
        np.testing.assert_array_equal(a, b)
    for pkg in (tmesh, jmesh):  # a .ply path reaches the PLY reader (tests/test_torch_mesh_ply.py)
        with pytest.raises(FileNotFoundError):
            pkg.load_mesh_asset("dragon.ply")


def test_write_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(17, 29, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError):
        write_png(path, img.astype(np.float32))
