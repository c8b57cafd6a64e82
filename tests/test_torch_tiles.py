"""The port's resumable tiled render (``checkpoint.TiledRenderJob``) vs
the JAX package's.

The resume of ``tests/test_checkpoint.py:37-55`` in the port, and jobs
that cross the packages: one begun by JAX as owner 0 of 2 and finished by
the port, and the reverse.  The two packages share the job layout, so the
assembled frame is the other package's frame to atol 1e-5 (the JAX side
is jitted; the scene is the small sphere-and-plane scene of the JAX test,
without a kd tree).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import checkpoint as jckpt
from dod_raytracer_tpu_torch import checkpoint as tckpt

CFG = dict(Width=24, Height=16, use_kdtree=False, ray_tile=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_scene(pkg, cfg):
    """tests/test_checkpoint.py:15-20, in either package."""
    b = pkg.SceneBuilder()
    b.add_sphere((0.0, 0.0, 2.0), 1.0, (0.9, 0.2, 0.2))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), (0.3, 0.3, 0.6))
    b.add_light((0.0, 3.0, -2.0), 3.0)
    return b.build(cfg) if pkg is J else b.build(cfg, device="cpu")


def test_tiled_render_resume(tmp_path):
    cfg = T.Config(**CFG)
    scene = make_scene(T, cfg)
    ref = T.render_image(scene, cfg, device="cpu").numpy()
    job = tckpt.TiledRenderJob(str(tmp_path / "job"), cfg, tile=64, device="cpu")
    partial = tckpt.TiledRenderJob(str(tmp_path / "job"), cfg, tile=64, owner=0, num_owners=2, device="cpu")
    assert partial.run(scene) is None  # half the tiles: not assemblable
    assert partial.done_tiles() == list(range(0, job.num_tiles, 2))
    img = job.run(scene)
    assert img is not None and img.dtype == np.float32 and img.shape == (16, 24, 3)
    np.testing.assert_allclose(img, ref, atol=1e-6)
    assert job.done_tiles() == list(range(job.num_tiles))
    assert job.write_seconds > 0.0


def test_job_layout(tmp_path):
    """Tile files, their dtype and shape, the padded last tile, and
    ray_tile=0 resolving through render._auto_ray_tile."""
    cfg = T.Config(**dict(CFG, Width=20, Height=10))  # 200 rays: 4 tiles of 64, the last padded
    job = tckpt.TiledRenderJob(str(tmp_path), cfg, device="cpu")
    assert (job.tile, job.num_tiles) == (64, 4)
    job.run(make_scene(T, cfg))
    assert sorted(os.listdir(tmp_path)) == [f"tile_{i:06d}.npy" for i in range(4)]
    tile = np.load(tmp_path / "tile_000003.npy")
    assert tile.dtype == np.float32 and tile.shape == (64, 3)
    auto = tckpt.TiledRenderJob(str(tmp_path / "auto"), dataclasses.replace(cfg, ray_tile=0), device="cpu")
    assert auto.tile == 200  # min(32768, n) off the card
    assert tckpt.TiledRenderJob(str(tmp_path / "big"), T.Config(ray_tile=0), device="cuda").tile == 262144


@pytest.mark.parametrize("first", ["jax", "port"])
def test_job_crosses_packages(tmp_path, first):
    """One package renders owner 0's tiles of 2; the other finishes the job
    with one owner, rendering only the tiles left, and assembles the first
    package's own frame to atol 1e-5."""
    jcfg, tcfg = J.Config(**CFG), T.Config(**CFG)
    jscene, tscene = make_scene(J, jcfg), make_scene(T, tcfg)
    jobs = {
        "jax": lambda d, **kw: jckpt.TiledRenderJob(d, jcfg, tile=64, **kw),
        "port": lambda d, **kw: tckpt.TiledRenderJob(d, tcfg, tile=64, device="cpu", **kw),
    }
    scenes = {"jax": jscene, "port": tscene}
    second = "port" if first == "jax" else "jax"
    ref = jobs[first](str(tmp_path / "alone")).run(scenes[first])
    work = str(tmp_path / "shared")
    assert jobs[first](work, owner=0, num_owners=2).run(scenes[first]) is None
    begun = {i: np.load(os.path.join(work, f"tile_{i:06d}.npy")) for i in (0, 2, 4)}
    img = jobs[second](work).run(scenes[second])
    assert img is not None and img.shape == (16, 24, 3)
    for i, tile in begun.items():  # the first package's tiles were kept, not rendered again
        np.testing.assert_array_equal(np.load(os.path.join(work, f"tile_{i:06d}.npy")), tile)
    np.testing.assert_allclose(img, ref, atol=1e-5)
