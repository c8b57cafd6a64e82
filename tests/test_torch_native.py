"""The port's native host runtime (``dod_raytracer_tpu_torch/native``)
against the JAX package: the C++ SAH kd builder bit-equal to JAX's numpy
builder, the port's ``build_kdtree`` tables equal to JAX's, the C++ OBJ
parser against JAX's Python parser, the fallback and its warning, and
the inverse-rendering example on the CPU.

Skips, as ``tests/test_native.py`` does, where ``g++`` cannot build a
library.
"""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import mesh as jmesh
from dod_raytracer_tpu.accel import _kdtree_np as jnp_kd
from dod_raytracer_tpu_torch import mesh as tmesh
from dod_raytracer_tpu_torch import native
from dod_raytracer_tpu_torch.accel import _kdtree_np as tnp_kd
from dod_raytracer_tpu_torch.accel import kdtree as tkd
from dod_raytracer_tpu_torch.io import read_png
from dod_raytracer_tpu_torch.native import build as nbuild
from dod_raytracer_tpu_torch.scene import scene_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEAPOT_OBJ = os.path.join(ROOT, "assets", "teapot.obj")


def _native_or_skip(name):
    try:
        native._load(name)
    except native.NativeUnavailable:
        pytest.skip(f"native lib {name} not buildable")


def _soup(seed, ntris):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ntris, 3, 3)) * 2.0).astype(np.float32)


def _mesh(name):
    if name == "teapot":
        return tmesh.load_mesh_asset("teapot")[0]
    return tmesh.procedural_dragon(num_tris=40000)[0]  # the JAX tests' at-scale dragon


BUILD_CASES = {
    "soup0_100": (lambda: _soup(0, 100), 8),
    "soup1_999": (lambda: _soup(1, 999), 8),
    "soup2_4096": (lambda: _soup(2, 4096), 8),
    "teapot": (lambda: _mesh("teapot"), 8),
    "dragon40k_mp8": (lambda: _mesh("dragon"), 8),  # config.ini's MaxPrims (the CLI's dragon)
    "dragon40k_mp192": (lambda: _mesh("dragon"), 192),  # bench.py's flagship MaxPrims
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_native_builder_bit_equal_to_jax_numpy(case):
    """Every array of BuiltKD, bit for bit, and the two ints."""
    _native_or_skip("kdtree_build")
    make, max_prims = BUILD_CASES[case]
    tv = make()
    ref = jnp_kd.build(tv, max_prims=max_prims)
    got = native.kdtree_native.build(tv, max_prims=max_prims)
    assert isinstance(got, tnp_kd.BuiltKD)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=f.name)
        else:
            assert a == b, f.name
    # and the port's own numpy builder, the fallback, is the same tree
    np.testing.assert_array_equal(tnp_kd.build(tv, max_prims=max_prims).prim_nums, ref.prim_nums)


TABLE_SHAPES = {
    "config_ini": {},  # MaxPrims=8, leaf_chunk_lanes=8
    "mp96_bl48": dict(MaxPrims=96, leaf_chunk_lanes=48),
    "treelets": dict(MaxPrims=8, leaf_chunk_lanes=8, treelet_cap=128),  # 611 nodes -> treelet tables
}
KD_TABLES = ("node_flag", "node_split", "node_right", "node_leaf_start", "node_leaf_lanes", "bounds_min",
             "bounds_max", "tri_perm", "block_orig", "block_g", "block_aabb", "tre_tbl", "top_tbl")


@pytest.mark.parametrize("shape", list(TABLE_SHAPES))
def test_build_kdtree_tables_equal_jax_teapot(shape, caplog):
    """The port's build_kdtree (native builder) against JAX's build_kdtree
    on the teapot, table by table, bit for bit (treelet tables in JAX's
    layout)."""
    _native_or_skip("kdtree_build")
    tv, tn = tmesh.load_mesh_asset("teapot")
    jb, tb = J.SceneBuilder(), T.SceneBuilder()
    for b in (jb, tb):
        b.add_mesh(tv, tn)
    kw = TABLE_SHAPES[shape]
    with caplog.at_level(logging.INFO, logger="dod_raytracer_tpu_torch"):
        tscene = tb.build(T.Config(**kw), device="cpu")
    assert any("kd build (native builder)" in r.getMessage() for r in caplog.records)
    jscene = jb.build(J.Config(**kw))
    got = scene_to_numpy(tscene)["kd"]
    assert (got["tre_tbl"] is not None) == (shape == "treelets")
    for name in KD_TABLES:
        ref = getattr(jscene.kd, name)
        if ref is None:
            assert got[name] is None, name
            continue
        ref = np.asarray(ref)
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, (name, got[name].shape, ref.shape)
        np.testing.assert_array_equal(got[name].view(np.uint8), ref.view(np.uint8), err_msg=name)


def test_objloader_teapot_bits():
    """The C++ parser rounds each decimal straight to float32, the Python
    parser through float64: on the teapot every vertex bit agrees (a
    difference would be counted here and must stay within 1 ulp)."""
    _native_or_skip("objloader")
    v_py, f_py, n_py = jmesh.load_obj(TEAPOT_OBJ, use_native=False)
    v_c, f_c, n_c = native.objloader_native.load_obj(TEAPOT_OBJ)
    np.testing.assert_array_equal(f_c, f_py)
    assert v_c.dtype == np.float32 and v_c.shape == v_py.shape
    ulps = np.abs(v_c.view(np.int32).astype(np.int64) - v_py.view(np.int32).astype(np.int64))
    assert int((ulps > 1).sum()) == 0
    assert int((ulps != 0).sum()) == 0, f"{int((ulps != 0).sum())} teapot coordinates differ by 1 ulp"
    assert n_c is None and n_py is None
    # the port's load_obj takes the native parser by default, its Python one without
    for use_native in (True, False):
        v, f, n = tmesh.load_obj(TEAPOT_OBJ, use_native=use_native)
        np.testing.assert_array_equal(v.view(np.uint32), v_py.view(np.uint32))
        np.testing.assert_array_equal(f, f_py)
        assert n is None


def test_objloader_normals_and_polygons(tmp_path):
    """Quads fan-triangulated, ``i//n`` corners and negative (relative)
    indices (tests/test_native.py:60-73)."""
    _native_or_skip("objloader")
    p = tmp_path / "poly.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\nvn 0 0 -1\n"
        "f 1//1 2//1 3//2 4//2\n"
        "f -4//-2 -3//-2 -2//-1\n"
    )
    v_py, f_py, n_py = jmesh.load_obj(str(p), use_native=False)
    for v_c, f_c, n_c in (native.objloader_native.load_obj(str(p)), tmesh.load_obj(str(p))):
        np.testing.assert_array_equal(v_c, v_py)
        np.testing.assert_array_equal(f_c, f_py)
        np.testing.assert_array_equal(n_c, n_py)
    assert f_py.shape == (3, 3) and n_py.shape == (3, 3, 3)
    assert native.objloader_native.load_obj(str(tmp_path / "missing.obj")) is None
    with pytest.raises(FileNotFoundError):
        tmesh.load_obj(str(tmp_path / "missing.obj"))


def test_fallback_warns_once_and_builds_the_same_tree(monkeypatch, caplog):
    """With no compiler the native libraries raise NativeUnavailable; the
    kd build and the OBJ load fall back to numpy and Python, with one
    WARNING a library that carries the compiler's error, and give the same
    results."""
    tv = tmesh.load_mesh_asset("teapot")[0]
    cfg = T.Config()
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(nbuild, "library_path", lambda name: os.path.join(str(ROOT), "_no_such_dir", name))
    monkeypatch.setenv("CXX", os.path.join(str(ROOT), "_no_such_compiler"))
    with caplog.at_level(logging.INFO, logger="dod_raytracer_tpu_torch"):
        built, builder = tkd.host_build(tv, cfg)
        again, _ = tkd.host_build(tv, cfg)
        kd = tkd.build_kdtree(tv, cfg, device="cpu")
        v, f, _ = tmesh.load_obj(TEAPOT_OBJ)
    assert builder == "numpy" and not native.loaded("kdtree_build")
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2, warnings  # one a library, however often it is asked for
    assert all("_no_such_compiler" in w for w in warnings), warnings  # the compiler's error
    assert any("kd build (numpy builder)" in r.getMessage() for r in caplog.records)
    ref = jnp_kd.build(tv)
    for b in (built, again):
        np.testing.assert_array_equal(b.prim_nums, ref.prim_nums)
        np.testing.assert_array_equal(b.node_split.view(np.uint32), ref.node_split.view(np.uint32))
    assert kd.node_flag.shape[0] == ref.node_flag.shape[0]
    v_py, f_py, _ = jmesh.load_obj(TEAPOT_OBJ, use_native=False)
    np.testing.assert_array_equal(v.view(np.uint32), v_py.view(np.uint32))
    np.testing.assert_array_equal(f, f_py)


def test_library_names_follow_source_and_flags(monkeypatch, tmp_path):
    """Each library is named by a hash of its source and flags, and a
    build goes through a temporary file renamed into place."""
    _native_or_skip("kdtree_build")
    a, b = nbuild.library_path("kdtree_build"), nbuild.library_path("objloader")
    assert a != b and os.path.basename(a).startswith("libkdtree_build_")
    assert os.path.dirname(a) == os.path.join(ROOT, "dod_raytracer_tpu_torch", "_build")
    monkeypatch.setattr(nbuild, "GXX_FLAGS", nbuild.GXX_FLAGS + ["-DUNUSED_FLAG"])
    assert nbuild.library_path("kdtree_build") != a
    monkeypatch.setattr(nbuild, "BUILD_DIR", str(tmp_path))
    out = nbuild.build("objloader")
    assert os.path.dirname(out["path"]) == str(tmp_path) and out["seconds"] > 0
    assert os.listdir(tmp_path) == [os.path.basename(out["path"])]  # no temporary file left
    assert nbuild.build("objloader")["seconds"] == 0.0  # built once


def test_inverse_rendering_example_on_cpu(tmp_path, capsys):
    """examples/inverse_rendering_torch.py at 24x16 for 3 steps on the CPU:
    three PNGs, and the loss falls."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("inverse_rendering_torch",
                                                  os.path.join(ROOT, "examples", "inverse_rendering_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = example.main(["--cpu", "--width", "24", "--height", "16", "--steps", "3", "--outdir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["initial.png", "recovered.png", "target.png"]
    for name in os.listdir(tmp_path):
        assert read_png(str(tmp_path / name)).shape == (16, 24, 3)
    out = capsys.readouterr().out
    line = next(s for s in out.splitlines() if s.startswith("loss "))
    first, last = (float(x) for x in line.split()[1:4:2])
    assert last < first, line
    assert "max albedo error" in out
    if not torch.cuda.is_available():  # without a GPU and without --cpu it exits 2
        assert example.main(["--outdir", str(tmp_path / "none")]) == 2
        assert not os.path.exists(tmp_path / "none")
