"""Rank functions and scenes of the port's distributed CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_leaf_shard.py``).

Each function runs in a process of a gloo world on the CPU started by
``parallel.multihost.spawn``, joins it through a ``file://`` rendezvous
(the caller's temporary directory: the test suite's workers run at once,
so no TCP port is shared), pins one torch thread, and returns numpy
results.  This module imports no JAX: ranks start from a fresh import.
The scene builders take the package (the JAX one or the port) as an
argument, so the tests build the same scenes in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.parallel import leaf_shard, multihost, sharding

# tests/test_sharding.py's configurations
DP_CASES = {
    "spheres": dict(Width=40, Height=24, use_kdtree=False, recursion_depth=3, ray_tile=960),
    "kd_teapot": dict(Width=32, Height=24, use_kdtree=True, recursion_depth=3, ray_tile=768),
}
STEP_CFG = dict(Width=32, Height=16, use_kdtree=False, recursion_depth=2)
STEP_PARAMS = ("spheres", "lights")
STEP_LR = 0.3
STEPS = 3
# tests/test_leaf_shard.py's configuration
LEAF_CFG = dict(Width=32, Height=24, use_kdtree=True, recursion_depth=3)
# the bounce and shadow sorts forced on the CPU tensors, and their unsorted twin
FORCED_SORTS = dict(sort_bounces=True, sort_shadow=True, shadow_batch_lights=True, traversal_backend="forest")
UNSORTED = dict(sort_bounces=False, sort_shadow=False, shadow_batch_lights=True, traversal_backend="forest")
STEP_2D_LR = 0.02
# the reference recipe's closed box of mirror walls around the teapot: rays
# bounce from one shard's triangles to another's (the teapot scene above
# shows only shard 0 to the camera), which the 2D gradient must follow
BOX_DEPTH = 5


def spheres_builder(pkg):
    """tests/test_sharding.py's build_scene."""
    b = pkg.SceneBuilder()
    b.add_sphere((0.0, 0.3, 2.0), 1.1, (0.8, 0.3, 0.2))
    b.add_sphere((-1.5, -0.5, 3.5), 0.9, (0.2, 0.7, 0.3))
    b.add_plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), (0.3, 0.3, 0.6))
    b.add_light((1.0, 3.0, -2.0), 3.0)
    return b


def kd_teapot_builder(pkg):
    """tests/test_sharding.py's kd case: 3,000 teapot triangles."""
    tv, tn = load_mesh_asset("teapot")
    b = pkg.SceneBuilder()
    b.add_mesh(tv[:3000], tn[:3000])
    b.add_sphere((2.0, 1.0, 1.0), 0.8, (0.9, 0.3, 0.2))
    b.add_plane((0.0, 0.0, 5.0), (0.0, 0.0, -1.0), (0.2, 0.4, 0.6))
    b.add_light((0.0, 3.0, -3.0), 3.0)
    return b


def leaf_builder(pkg, soup=None):
    """tests/test_leaf_shard.py's build: 2,000 teapot triangles (or the
    (verts, normals) ``soup``), a sphere, a wall, two lights."""
    if soup is None:
        tv, tn = load_mesh_asset("teapot")
        soup = (tv[:2000], tn[:2000])
    b = pkg.SceneBuilder()
    b.add_mesh(*soup)
    b.add_sphere((2.0, 1.0, 1.0), 0.8, (0.9, 0.3, 0.2))
    b.add_plane((0.0, 0.0, 5.0), (0.0, 0.0, -1.0), (0.2, 0.4, 0.6))
    b.add_light((0.0, 3.0, -3.0), 3.0)
    b.add_light((3.0, 1.0, -2.0), 2.0)
    return b


def box_builder(pkg, soup=None):
    """``default_scene(seed=0)`` with the teapot (or the (verts, normals)
    ``soup``): 16 spheres, 6 walls, the cylinder, 9 lights."""
    b = pkg.default_scene(seed=0, mesh=None)
    b.add_mesh(*(soup or load_mesh_asset("teapot")))
    return b


def numpy_tree(obj):
    """A Scene of either package as nested dicts of numpy arrays and
    static values (``scene.scene_from_numpy``'s input)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj) if hasattr(obj, "__array__") else obj


def _join(rank: int, world: int, init: str) -> str:
    torch.set_num_threads(1)
    return multihost.initialize(init, world, rank, device="cpu")


def dp_world(rank: int, world: int, init: str) -> dict:
    """The mesh checks, the dp renders of ``DP_CASES`` and the 1D train step."""
    out = {"backend": _join(rank, world, init), "coordinator": multihost.is_coordinator()}
    m1 = multihost.global_mesh(device="cpu")
    m2 = multihost.global_mesh(("dp", "mp"), device="cpu")
    out["shapes"] = {"1d": (m1.axis_names, m1.shape), "2d_default": (m2.axis_names, m2.shape)}
    try:
        multihost.global_mesh(("a", "b", "c"), device="cpu")
    except ValueError:
        out["three_axes"] = "ValueError"
    # tests/test_multihost.py:38-50 on a (2, world // 2) mesh: x + psum over mp + psum over dp
    mesh = multihost.global_mesh(("dp", "mp"), (2, world // 2), device="cpu")
    x = torch.tensor(float(rank))
    over = {}
    for axis in ("mp", "dp"):
        over[axis] = x.clone()
        torch.distributed.all_reduce(over[axis], group=mesh.groups[axis])
    out["collectives"] = dict(coords=mesh.coords, value=float(x + over["mp"] + over["dp"]))

    dp = sharding.make_mesh(world, device="cpu")
    builders = {"spheres": spheres_builder, "kd_teapot": kd_teapot_builder}
    out["frames"] = {}
    for name, kw in DP_CASES.items():
        cfg = T.Config(**kw)
        scene = sharding.replicate_scene(builders[name](T).build(cfg, device="cpu"), dp)
        out["frames"][name] = sharding.render_image_sharded(scene, cfg, dp).numpy()

    cfg = T.Config(**STEP_CFG)
    scene = sharding.replicate_scene(spheres_builder(T).build(cfg, device="cpu"), dp)
    target = torch.full((cfg.Width * cfg.Height, 3), 0.25)
    loss, grads = sharding.loss_and_param_grads_sharded(scene, target, cfg, dp, STEP_PARAMS)
    out["step"] = dict(loss=float(loss), grads={p: {k: (None if g is None else g.numpy())
                                                     for k, g in vars(fam).items()}
                                                 for p, fam in grads.items()})
    step = sharding.make_train_step(cfg, dp, STEP_PARAMS, lr=STEP_LR)
    losses = []
    for _ in range(STEPS):
        loss, scene = step(scene, target)
        losses.append(float(loss))
    out["step"]["losses"] = losses
    return out


def leaf_world(rank: int, world: int, init: str, cases: dict) -> dict:
    """The ``cases`` on leaf-sharded scenes: name -> ((dp, mp) shape,
    config overrides, source), the source "leaf" or "box" (that builder's
    shards built here) or the JAX package's stacked scene as numpy.  A
    case named "grad..." gives the 2D step's loss and vertex gradient
    (target 0), "step_2d" then ``STEPS`` steps too; any other the frame."""
    out = {"backend": _join(rank, world, init), "frames": {}}
    meshes, scenes = {}, {}
    for name, (shape, over, source) in cases.items():
        if shape not in meshes:
            meshes[shape] = multihost.global_mesh(("dp", "mp"), shape, device="cpu")
        mesh = meshes[shape]
        cfg = T.Config(**dict(LEAF_CFG, **over), tri_shard_axis="mp")
        key = (shape, source if isinstance(source, str) else "jax")
        if key not in scenes:
            if isinstance(source, str):
                builder = {"leaf": leaf_builder, "box": box_builder}[source](T)
                scenes[key] = leaf_shard.make_leaf_sharded_scene(builder, cfg, mesh, device="cpu")
            else:
                scenes[key] = leaf_shard.local_scene_from_numpy(source, mesh.coords["mp"], mesh.groups["mp"],
                                                                device="cpu")
        scene = scenes[key]
        if name.startswith(("grad", "step_2d")):
            target = torch.zeros((cfg.Width * cfg.Height, 3))
            loss, grad = leaf_shard.loss_and_vertex_grads_2d(scene, target, cfg, mesh)
            out[name] = dict(coords=mesh.coords, loss=float(loss), grad=grad.numpy())
        if name == "step_2d":
            step = leaf_shard.make_train_step_2d(cfg, mesh, lr=STEP_2D_LR)
            s, losses = scene, []
            for _ in range(STEPS):
                l_k, s = step(s, target)
                losses.append(float(l_k))
            out[name].update(losses=losses, moved=float((s.triangles.verts - scene.triangles.verts).abs().max()),
                             blocks_moved=float((s.kd.block_tris - scene.kd.block_tris).abs().max()))
        elif not name.startswith("grad"):
            out["frames"][name] = leaf_shard.render_image_leaf_sharded(scene, cfg, mesh).numpy()
    return out


def rank_world(rank: int, world: int, init: str, leaf_cases: dict) -> dict:
    """One world for every distributed case: ``dp_world``, then
    ``leaf_world`` on ``leaf_cases`` in the same process group."""
    return {"dp": dp_world(rank, world, init), "leaf": leaf_world(rank, world, init, leaf_cases)}
