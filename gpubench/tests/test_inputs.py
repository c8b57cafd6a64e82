"""The benchmark's frozen inputs against the program's own scene recipe."""

import json
import os

import numpy as np
import pytest

import dod_raytracer_tpu_torch as port
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from gpubench.scenes import inputs
from gpubench.scenes.objreader import load_obj_mesh

CONFIGS = os.path.join(inputs.ROOT, "gpubench", "configs")
SEEDS = (0, 7, 2**31 + 12345)


def scene_cfg(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)["scene"]


def built(builder):
    return builder.build(port.Config(use_kdtree=False), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_draws_are_default_scenes(seed):
    pos, col, cyl = inputs.reference_draws(seed)
    s = built(port.default_scene(seed=seed, mesh=None))
    assert np.array_equal(s.spheres.center.numpy(), pos)
    assert np.array_equal(s.spheres.color.numpy(), col)
    assert np.array_equal(s.cylinders.color.numpy()[0], cyl)


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_arrays_reach_the_program_unchanged(seed):
    cfg = scene_cfg("teapot-ref")
    arrays = inputs.scene_arrays(cfg, seed, inputs.load_mesh(cfg))
    s = built(inputs.to_builder(port, arrays))
    ref = built(port.default_scene(seed=cfg["layout_seed"], mesh="teapot"))
    # every seed: the layout's places in another order, its own colours
    assert sorted(map(tuple, s.spheres.center.numpy())) == sorted(map(tuple, ref.spheres.center.numpy()))
    assert np.array_equal(s.spheres.color.numpy(), inputs.reference_draws(seed)[1])
    for fam in ("planes", "lights"):
        for a, b in zip(vars(getattr(s, fam)).values(), vars(getattr(ref, fam)).values()):
            assert np.array_equal(a.numpy(), b.numpy())
    for f in ("base", "axis", "radius", "height"):
        assert np.array_equal(getattr(s.cylinders, f).numpy(), getattr(ref.cylinders, f).numpy())
    for f in ("verts", "normals", "mesh_id"):
        assert np.array_equal(getattr(s.triangles, f).numpy(), getattr(ref.triangles, f).numpy())
    assert np.array_equal(s.mesh_colors.numpy(), ref.mesh_colors.numpy())


def test_obj_reader_is_the_programs_teapot():
    v, n = load_obj_mesh(os.path.join(inputs.ROOT, "assets", "teapot.obj"))
    pv, pn = load_mesh_asset("teapot")
    assert v.shape == (6320, 3, 3)
    assert np.array_equal(v, pv) and np.array_equal(n, pn)


def test_changed_mesh_file_is_refused():
    cfg = dict(scene_cfg("teapot-ref"), mesh_sha256="0" * 64)
    with pytest.raises(RuntimeError, match="SHA-256"):
        inputs.load_mesh(cfg)
