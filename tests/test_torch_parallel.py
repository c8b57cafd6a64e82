"""The port's distribution (``dod_raytracer_tpu_torch.parallel``:
``multihost.py``, ``sharding.py``, ``leaf_shard.py``, ``tri_shard_axis``)
against the JAX package's (``tests/test_multihost.py``,
``tests/test_sharding.py``, ``tests/test_leaf_shard.py``), in gloo worlds
of 2 and 4 CPU processes.  (The leaf-sharded build, in one process:
``tests/test_torch_leaf_shard.py``.)

One world of each size is spawned for the module
(``tests/torch_parallel_ranks.py`` ``rank_world``) and runs every case;
the JAX side runs here, on ``conftest.py``'s 8 virtual CPU devices.
Tolerances:

* a dp frame against the port's single-process frame: atol 1e-6, the
  bound ``tests/test_sharding.py`` holds JAX's sharded frame to; against
  JAX's ``render_image_sharded``: no further than the port's
  single-process frame is from JAX's ``render_image``, plus that 1e-6;
* the 1D step's loss against JAX's ``loss_and_param_grads`` to rtol 1e-5
  (``tests/test_sharding.py:36-46``); its grads against the port's
  single-process grads to rtol 1e-5 (atol 1e-7): the ranks' sums add the
  pixels in another order;
* a leaf-sharded frame against the port's replicated frame: atol 2e-5,
  JAX's own bound (``tests/test_leaf_shard.py``); against JAX's
  ``render_image_leaf_sharded`` on the same mesh shape: no further than
  the port's replicated frame is from JAX's ``render_image``, plus 2e-5;
* the bounce and shadow sorts forced on: the frame equals the unsorted
  sharded frame bit for bit (both sorts are exact permutations, and every
  rank of a shard group must permute its rays alike);
* the 2D step: its first loss equals JAX's ``make_train_step_2d``'s to
  rtol 1e-5; its vertex gradient equals the unsharded gradient (the
  port's single-process one and JAX's ``jax.grad``, both on the
  Morton-ordered soup) at ``tests/test_torch_grad.py``'s vertex
  tolerance, rtol 1e-3 and atol 1e-6 of the largest grad, and does not
  equal JAX's 2D step's, which is scaled by the mp size and lacks the
  gradient through the combined t.  That scene shows the camera shard 0
  alone, so a second case, the reference recipe's closed box of mirror
  walls around the whole teapot, holds the 2D gradient to the port's
  single-process one where rays bounce from one shard's triangles to
  another's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu import grad as jgrad
from dod_raytracer_tpu.grad import loss_and_param_grads as j_loss_and_param_grads
from dod_raytracer_tpu.parallel import leaf_shard as jls
from dod_raytracer_tpu.parallel import make_mesh as j_make_mesh
from dod_raytracer_tpu.parallel import render_image_sharded as j_render_image_sharded
from dod_raytracer_tpu.parallel import replicate_scene as j_replicate_scene
from dod_raytracer_tpu.render import _FrozenConfig
from dod_raytracer_tpu_torch.grad import loss_and_param_grads, mse_loss
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.parallel import multihost

import torch_parallel_ranks as R

WORLDS = (2, 4)
DP_JAX_DEVICES = {"spheres": 2, "kd_teapot": 4}  # one JAX sharded frame a case (JAX's is the same on any mesh)
VERTEX_RTOL, VERTEX_ATOL = 1e-3, 1e-6  # tests/test_torch_grad.py, atol of the largest grad


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_scenes():
    """nmp -> JAX's stacked leaf-sharded scene of the leaf builder."""
    cfg = J.Config(**R.LEAF_CFG, tri_shard_axis="mp")
    return {nmp: jls.make_leaf_sharded_scene(R.leaf_builder(J), cfg, nmp) for nmp in (2, 4)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_scenes):
    """world size -> each rank's ``rank_world`` results: the dp cases, and
    the leaf-sharded ones: in the world of 2, (1, 2) frames plain, with
    the sorts forced on and their unsorted twin, and the box's 2D
    gradient; in the world of 4, the (2, 2) frame built there, the (1, 4)
    frame from JAX's stacked scene, and the 2D step on (2, 2)."""
    leaf_cases = {
        2: {"plain_1x2": ((1, 2), {}, "leaf"), "sorted_1x2": ((1, 2), R.FORCED_SORTS, "leaf"),
            "unsorted_1x2": ((1, 2), R.UNSORTED, "leaf"),
            "grad_box": ((1, 2), {"recursion_depth": R.BOX_DEPTH}, "box")},
        4: {"plain_2x2": ((2, 2), {}, "leaf"), "plain_1x4": ((1, 4), {}, R.numpy_tree(jax_scenes[4])),
            "step_2d": ((2, 2), {}, "leaf")},
    }
    out = {}
    for world in WORLDS:
        rdzv = tmp_path_factory.mktemp(f"world{world}") / "rendezvous"
        out[world] = multihost.spawn(world, R.rank_world, f"file://{rdzv}", leaf_cases[world], timeout_s=300)
    return out


# ---- multihost ----

def test_global_mesh_shapes(worlds):
    for world, ranks in worlds.items():
        for r in ranks:
            r = r["dp"]
            assert r["backend"] == "gloo"
            assert r["shapes"]["1d"] == (("dp",), {"dp": world})
            # one host: the default 2D shape puts every rank on the second axis
            assert r["shapes"]["2d_default"] == (("dp", "mp"), {"dp": 1, "mp": world})
            assert r["three_axes"] == "ValueError"
        assert [r["dp"]["coordinator"] for r in ranks] == [True] + [False] * (world - 1)


def test_mesh_carries_collectives(worlds):
    """tests/test_multihost.py:38-50: x + psum over mp + psum over dp."""
    for world, ranks in worlds.items():
        x = np.arange(float(world)).reshape(2, world // 2)
        expect = x + x.sum(axis=1, keepdims=True) + x.sum(axis=0, keepdims=True)
        for rank, r in enumerate(ranks):
            c = r["dp"]["collectives"]["coords"]
            assert np.unravel_index(rank, x.shape) == (c["dp"], c["mp"])
            assert r["dp"]["collectives"]["value"] == expect[c["dp"], c["mp"]]


def test_initialize_world_of_one_is_idempotent():
    """Without a rendezvous or torchrun's environment: a world of one,
    joined once however often it is asked."""
    try:
        assert multihost.initialize(device="cpu") == "gloo"
        assert multihost.initialize(device="cpu") == "gloo"
        assert multihost.is_coordinator()
        assert torch.distributed.get_world_size() == 1
        mesh = multihost.global_mesh(("dp", "mp"), device="cpu")
        assert mesh.shape == {"dp": 1, "mp": 1} and mesh.coords == {"dp": 0, "mp": 0}
    finally:
        torch.distributed.destroy_process_group()


# ---- the dp render and the 1D step ----

@pytest.fixture(scope="module")
def dp_refs():
    """case -> (the port's single-process frame, JAX's single-device and
    sharded frames; JAX's on DP_JAX_DEVICES[case] devices)."""
    builders = {"spheres": R.spheres_builder, "kd_teapot": R.kd_teapot_builder}
    out = {}
    for case, builder in builders.items():
        cfg_t, cfg_j = T.Config(**R.DP_CASES[case]), J.Config(**R.DP_CASES[case])
        single = T.render_image(builder(T).build(cfg_t, device="cpu"), cfg_t, device="cpu").numpy()
        jscene = builder(J).build(cfg_j)
        mesh = j_make_mesh(DP_JAX_DEVICES[case])
        out[case] = (single, np.asarray(J.render_image(jscene, cfg_j)),
                     np.asarray(j_render_image_sharded(j_replicate_scene(jscene, mesh), cfg_j, mesh)))
    return out


@pytest.mark.parametrize("case,world", [("spheres", 2), ("spheres", 4), ("kd_teapot", 2), ("kd_teapot", 4)])
def test_sharded_render_matches_single(worlds, dp_refs, case, world):
    single, j_single, j_sharded = dp_refs[case]
    tol = float(np.abs(single - j_single).max()) + 1e-6
    for r in worlds[world]:
        frame = r["dp"]["frames"][case]
        np.testing.assert_allclose(frame, single, atol=1e-6)
        assert float(np.abs(frame - j_sharded).max()) <= tol


@pytest.fixture(scope="module")
def single_step():
    """The port's single-process loss and grads of the step's scene and
    target, and JAX's loss."""
    cfg_t, cfg_j = T.Config(**R.STEP_CFG), J.Config(**R.STEP_CFG)
    target = np.full((cfg_t.Height, cfg_t.Width, 3), 0.25, np.float32)
    loss, grads = loss_and_param_grads(R.spheres_builder(T).build(cfg_t, device="cpu"), torch.from_numpy(target),
                                       cfg_t, params=R.STEP_PARAMS)
    j_loss, _ = j_loss_and_param_grads(R.spheres_builder(J).build(cfg_j), jnp.asarray(target), cfg_j,
                                       params=R.STEP_PARAMS)
    return float(loss), grads, float(j_loss)


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_matches_jax_loss_and_single_grads(worlds, single_step, world):
    loss, grads, j_loss = single_step
    for r in worlds[world]:
        step = r["dp"]["step"]
        np.testing.assert_allclose(step["loss"], j_loss, rtol=1e-5)
        np.testing.assert_allclose(step["loss"], loss, rtol=1e-5)
        for p, fam in grads.items():
            for k, g in vars(fam).items():
                got = step["grads"][p][k]
                assert (got is None) == (g is None), (p, k)
                if g is not None:
                    np.testing.assert_allclose(got, g.numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{p}.{k}")


@pytest.mark.parametrize("world", WORLDS)
def test_train_step_descends(worlds, world):
    for r in worlds[world]:
        losses = r["dp"]["step"]["losses"]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert losses == worlds[world][0]["dp"]["step"]["losses"]  # every rank steps alike


# ---- the leaf-sharded render and the 2D step ----

@pytest.fixture(scope="module")
def replicated():
    """The port's and JAX's replicated frames."""
    cfg_t, cfg_j = T.Config(**R.LEAF_CFG), J.Config(**R.LEAF_CFG)
    port = T.render_image(R.leaf_builder(T).build(cfg_t, device="cpu"), cfg_t, device="cpu").numpy()
    return port, np.asarray(J.render_image(R.leaf_builder(J).build(cfg_j), cfg_j))


@pytest.mark.parametrize("ndp,nmp,world,case", [(2, 2, 4, "plain_2x2"), (1, 2, 2, "plain_1x2"),
                                                 (1, 4, 4, "plain_1x4")])
def test_leaf_sharded_matches_replicated(worlds, jax_scenes, replicated, ndp, nmp, world, case):
    port, j_ref = replicated
    cfg = J.Config(**R.LEAF_CFG, tri_shard_axis="mp")
    mesh = Mesh(np.asarray(jax.devices()[: ndp * nmp]).reshape(ndp, nmp), ("dp", "mp"))
    j_frame = np.asarray(jls.render_image_leaf_sharded(jax_scenes[nmp], cfg, mesh))
    tol = float(np.abs(port - j_ref).max()) + 2e-5
    for r in worlds[world]:
        assert r["leaf"]["backend"] == "gloo"
        frame = r["leaf"]["frames"][case]
        np.testing.assert_allclose(frame, port, atol=2e-5)
        assert float(np.abs(frame - j_frame).max()) <= tol


def test_forced_sorts_keep_the_sharded_frame(worlds, replicated):
    """sort_bounces, sort_shadow (batched shadows) and 'forest' forced on
    the CPU tensors: every rank of the shard group permutes its rays
    alike (whole-scene keys), so the frame is the unsorted one's."""
    for r in worlds[2]:
        frames = r["leaf"]["frames"]
        np.testing.assert_array_equal(frames["sorted_1x2"], frames["unsorted_1x2"])
        np.testing.assert_allclose(frames["sorted_1x2"], replicated[0], atol=2e-5)


@pytest.fixture(scope="module")
def unsharded_grads(jax_scenes):
    """The loss's vertex gradient on the Morton-ordered soup, unsharded:
    the port's single-process one and JAX's jax.grad; and JAX's 2D step's
    first loss and vertex step at lr 1 on the (2, 2) mesh."""
    tv, tn = load_mesh_asset("teapot")
    order = jls._morton_order(tv[:2000])
    msoup = (tv[:2000][order], tn[:2000][order])
    target = np.zeros((R.LEAF_CFG["Height"], R.LEAF_CFG["Width"], 3), np.float32)

    cfg_t = T.Config(**R.LEAF_CFG)
    scene = R.leaf_builder(T, msoup).build(cfg_t, device="cpu")
    verts = scene.triangles.verts.detach().clone().requires_grad_(True)
    mse_loss(dataclasses.replace(scene, triangles=dataclasses.replace(scene.triangles, verts=verts)),
             torch.from_numpy(target), cfg_t).backward()

    frozen = _FrozenConfig.from_config(J.Config(**R.LEAF_CFG))
    jscene = R.leaf_builder(J, msoup).build(frozen)

    def loss(v):
        return jgrad.mse_loss(jscene.replace(triangles=jscene.triangles.replace(verts=v)), jnp.asarray(target), frozen)

    g_jax = np.asarray(jax.jit(jax.grad(loss))(jscene.triangles.verts))

    cfg = J.Config(**R.LEAF_CFG, tri_shard_axis="mp")
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    s0 = jax_scenes[2]
    j_loss, s1 = jls.make_train_step_2d(cfg, mesh, lr=1.0)(s0, jnp.zeros((target.size // 3, 3)))
    g_2d = np.asarray(s0.triangles.verts - s1.triangles.verts).reshape(-1, 3, 3)[:order.shape[0]]
    return verts.grad.numpy(), g_jax, float(j_loss), g_2d


def gathered(ranks, case):
    """The 2D vertex gradient of ``case`` gathered over the shards in
    order (dp replicas of a shard must hold the same all-reduced one)."""
    runs = [r["leaf"][case] for r in ranks]
    by_mp = {run["coords"]["mp"]: run["grad"] for run in runs if run["coords"]["dp"] == 0}
    for run in runs:
        np.testing.assert_array_equal(run["grad"], by_mp[run["coords"]["mp"]])
    return np.concatenate([by_mp[i] for i in range(len(by_mp))])


def test_train_step_2d_gradient_is_unsharded(worlds, unsharded_grads):
    g_port, g_jax, j_loss, g_jax_2d = unsharded_grads
    grad = gathered(worlds[4], "step_2d")[:g_port.shape[0]]
    for r in worlds[4]:
        np.testing.assert_allclose(r["leaf"]["step_2d"]["loss"], j_loss, rtol=1e-5)
    for ref in (g_port, g_jax):
        np.testing.assert_allclose(grad, ref, rtol=VERTEX_RTOL, atol=VERTEX_ATOL * np.abs(ref).max())
    ratio = np.linalg.norm(g_jax_2d) / np.linalg.norm(g_jax)
    cosine = float((g_jax_2d * g_jax).sum() / (np.linalg.norm(g_jax_2d) * np.linalg.norm(g_jax)))
    print(f"JAX's 2D step at mp=2: |g| {ratio:.4f} x the unsharded gradient's, cosine {cosine:.4f}")
    assert not np.allclose(g_jax_2d, g_jax, rtol=VERTEX_RTOL, atol=VERTEX_ATOL * np.abs(g_jax).max())


def test_train_step_2d_gradient_follows_rays_across_shards(worlds):
    """In the closed box of mirror walls rays bounce from one shard's
    triangles to the other's: each bounce's rays carry the cotangent of
    the later hits to the earlier ones' owners (``_CopyToShards``), and
    the gradient equals the port's single-process one on the
    Morton-ordered soup at the vertex tolerance."""
    tv, tn = load_mesh_asset("teapot")
    order = jls._morton_order(tv)
    cfg = T.Config(**dict(R.LEAF_CFG, recursion_depth=R.BOX_DEPTH))
    scene = R.box_builder(T, (tv[order], tn[order])).build(cfg, device="cpu")
    verts = scene.triangles.verts.detach().clone().requires_grad_(True)
    loss = mse_loss(dataclasses.replace(scene, triangles=dataclasses.replace(scene.triangles, verts=verts)),
                    torch.zeros((cfg.Height, cfg.Width, 3)), cfg)
    loss.backward()
    ref = verts.grad.numpy()
    grad = gathered(worlds[2], "grad_box")[:ref.shape[0]]
    assert (np.abs(grad.reshape(2, -1)) > 0).any(axis=1).all()  # both shards' triangles are seen
    for r in worlds[2]:
        np.testing.assert_allclose(r["leaf"]["grad_box"]["loss"], float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(grad, ref, rtol=VERTEX_RTOL, atol=VERTEX_ATOL * np.abs(ref).max())


def test_train_step_2d_descends(worlds):
    """The loss falls on every rank, the vertices move (those of a shard
    that no ray reaches get no gradient), and each shard's leaf blocks
    are refreshed from its moved vertices."""
    steps = [r["leaf"]["step_2d"] for r in worlds[4]]
    for s in steps:
        assert all(np.isfinite(s["losses"])) and s["losses"][-1] < s["losses"][0], s["losses"]
        assert (s["blocks_moved"] > 0.0) == (s["moved"] > 0.0)
    assert max(s["moved"] for s in steps) > 0.0
