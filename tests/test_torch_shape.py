"""The shape fit's program side on the CPU: a welded mesh's joined vertex
positions as a fit leaf ('triangles.positions'), the corners and smooth
normals derived from them in autograd (``mesh.derive``), and the kd tree
kept conservative as they move (``accel.kdtree.follow_vertices``).

Held against the benchmark's plain reference
(``gpubench/reference/shape_fit.py``, plain torch, no program code), the
loader's flattened mesh, autograd's own chain rule, and the kernels' leaf
test run over every triangle (``ops.triangle.edge_sign_brute_*``, which
the plain walks equal with no excuse).  Frames are at most 24x16 with 2-3
bounces, on one torch thread."""

import dataclasses

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu_torch import grad as tgrad
from dod_raytracer_tpu_torch import mesh as tmesh
from dod_raytracer_tpu_torch import train as ttrain
from dod_raytracer_tpu_torch.accel.kdtree import PAD_MAX, refresh_kd_blocks
from dod_raytracer_tpu_torch.ops import triangle as ttri
from dod_raytracer_tpu_torch.ops.traverse import kd_any, kd_closest
from dod_raytracer_tpu_torch.utils import profiling

LEAF = "triangles.positions"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def teapot():
    return tmesh.load_welded("teapot")


def welded_scene(positions, faces, cfg, seed=0):
    b = T.default_scene(seed=seed, cfg=cfg, mesh=None)
    b.add_welded_mesh(positions, faces)
    return b.build(cfg, device="cpu")


def noisy(positions, seed, sigma=0.0082):
    rng = np.random.default_rng(seed)
    return (positions + rng.normal(0.0, sigma, positions.shape)).astype(np.float32)


def test_derived_corners_bit_equal_and_normals_close_to_the_loader(teapot):
    positions, faces = teapot
    assert positions.shape == (3241, 3) and faces.shape == (6320, 3)
    verts, normals = tmesh.load_mesh_asset("teapot")
    cfg = T.Config(MaxPrims=96, leaf_chunk_lanes=48)
    scene = welded_scene(positions, faces, cfg)
    np.testing.assert_array_equal(scene.triangles.verts.numpy().view(np.uint32), verts.view(np.uint32))
    np.testing.assert_allclose(scene.triangles.normals.numpy(), normals, rtol=0, atol=1e-6)
    assert scene.kd.lane_lo is not None and scene.kd.build_cfg is cfg
    # the tree of the welded mesh is the soup's, and so is every frame
    soup = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
    for f in ("node_flag", "node_split", "tri_perm", "block_tris", "block_g", "bounds_min", "bounds_max"):
        assert torch.equal(getattr(scene.kd, f), getattr(soup.kd, f)), f


def test_refiling_at_the_build_boxes_keeps_every_leaf(teapot):
    """``_kdtree_np.refile`` with the build's own lane boxes files every lane
    into at least the leaves the SAH build put it in (a lane's box meets
    the cell of each of them), and gives the build's root box."""
    from dod_raytracer_tpu_torch.accel import _kdtree_np

    positions, faces = teapot
    tv = positions[faces]
    built = _kdtree_np.build(tv, lane_size=8, max_prims=8)
    mins, maxs = _kdtree_np.lane_bounds(tv, 8)
    again = _kdtree_np.refile(built.node_flag, built.node_split, built.node_right, mins, maxs, built.max_depth)
    leaves = np.flatnonzero(built.node_flag == _kdtree_np.LEAF_FLAG)
    assert leaves.size > 100
    for i in leaves:
        was = built.prim_nums[built.node_leaf_start[i]:built.node_leaf_start[i] + built.node_leaf_lanes[i]]
        now = again.prim_nums[again.node_leaf_start[i]:again.node_leaf_start[i] + again.node_leaf_lanes[i]]
        assert set(was.tolist()) <= set(now.tolist()), i
    np.testing.assert_array_equal(again.bounds_min, built.bounds_min)
    np.testing.assert_array_equal(again.bounds_max, built.bounds_max)


def test_mixing_welded_meshes_and_soups_is_refused(teapot):
    b = T.SceneBuilder()
    b.add_welded_mesh(*teapot)
    with pytest.raises(ValueError):
        b.add_mesh(np.zeros((1, 3, 3)), np.zeros((1, 3, 3)))


def test_position_gradient_is_the_corner_and_normal_gradients_summed_over_welded_corners(teapot):
    """d loss / d positions = the corners' gradient summed over each joined
    vertex's corners, plus the normals' gradient carried through the
    smooth-normal rule."""
    positions, faces = teapot
    cfg = T.Config(Width=20, Height=14, recursion_depth=2, MaxPrims=96, leaf_chunk_lanes=48)
    scene = welded_scene(positions, faces, cfg)
    target = tgrad.render_for_grad(scene, cfg)
    moved = tgrad.follow_moves(scene, tgrad.merge_params(scene, {LEAF: torch.from_numpy(noisy(positions, 1))}))
    _, g = tgrad.loss_and_param_grads(moved, target, cfg, params=(LEAF,))
    g_pos = g[LEAF]
    tris = moved.triangles
    v_leaf, n_leaf = tris.verts.clone().requires_grad_(True), tris.normals.clone().requires_grad_(True)
    loss = tgrad.mse_loss(dataclasses.replace(moved, triangles=dataclasses.replace(tris, verts=v_leaf, normals=n_leaf)),
                          target, cfg)
    g_v, g_n = torch.autograd.grad(loss, (v_leaf, n_leaf))
    corner_part = np.zeros(positions.shape, np.float64)
    np.add.at(corner_part, tris.faces.numpy().reshape(-1), g_v.numpy().reshape(-1, 3).astype(np.float64))
    pos = tris.positions.clone().requires_grad_(True)
    (normal_part,) = torch.autograd.grad(tmesh.derive(pos, tris.faces)[1], pos, g_n)
    want = corner_part + normal_part.numpy()
    assert np.abs(corner_part).max() > 0 and np.abs(normal_part.numpy()).max() > 0
    np.testing.assert_allclose(g_pos.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


def test_loss_and_position_gradient_match_the_plain_reference(teapot):
    """The port's loss and position gradient at perturbed positions against
    ``gpubench/reference/shape_fit.py``'s (its own trace, its own target)."""
    from gpubench.reference import shape_fit as ref_shape
    from gpubench.scenes import inputs

    positions, faces = teapot
    w, h, depth = 24, 16, 3
    cfg = T.Config(Width=w, Height=h, recursion_depth=depth, MaxPrims=96, leaf_chunk_lanes=48)
    scene_cfg = {"num_spheres": 16, "with_cylinder": True, "layout_seed": 0}
    arrays = {**inputs.scene_arrays(scene_cfg, 11), "mesh_color": np.array([inputs.MESH_COLOR], np.float32)}

    def program(p):
        b = inputs.to_builder(T, arrays)
        b.add_welded_mesh(p, faces, inputs.MESH_COLOR)
        return b.build(cfg, device="cpu")

    target = tgrad.render_for_grad(program(positions), cfg).clamp(0.0, 1.0)
    start = program(noisy(positions, 2))
    leaf = start.triangles.positions.clone().requires_grad_(True)
    img = tgrad.render_for_grad(tgrad.merge_params(start, {LEAF: leaf}), cfg)
    loss = torch.mean((img.clamp(0.0, 1.0) - target) ** 2)  # the cell's loss: the image as shown
    (g,) = torch.autograd.grad(loss, leaf)
    s = ref_shape.ShapeScene(arrays, positions, faces, cfg.Epsilon, "cpu")
    ref_target = ref_shape.image(s, w, h, depth).clamp(0.0, 1.0)
    ref_loss, ref_g = ref_shape.loss_and_grad(s, torch.from_numpy(noisy(positions, 2)), ref_target, w, h, depth)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-4)
    a, b = g.double(), ref_g.double()
    assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-3


def _rays_at(targets, n_random, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.5, 4.5, (targets.shape[0] + n_random, 3)).astype(np.float32)
    aim = np.concatenate([targets, rng.uniform(-4.0, 4.0, (n_random, 3))]).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


def test_moved_triangles_are_found_by_every_walk(teapot):
    """Vertices moved across split planes and out of the root box, each by
    more than the rebuild's padding: the closest-hit and any-hit walks give
    the hits of the kernels' leaf test over every triangle, and the tree
    left as it was (its blocks repacked only) does not."""
    positions, faces = teapot
    cfg = T.Config(MaxPrims=8, leaf_chunk_lanes=8)
    scene = welded_scene(positions, faces, cfg)
    rng = np.random.default_rng(5)
    moved = positions.copy()
    pick = rng.choice(positions.shape[0], 160, replace=False)
    moved[pick] += rng.normal(0.0, 0.4, (160, 3)).astype(np.float32)
    top = np.argmax(positions[:, 0])
    moved[top, 0] += 1.5  # out of the root box
    diag = float(np.linalg.norm(positions.max(0) - positions.min(0)))
    assert np.abs(moved - positions).max() > PAD_MAX * diag
    profiling.enable()
    try:
        out = tgrad.follow_moves(scene, tgrad.merge_params(scene, {LEAF: torch.from_numpy(moved)}))
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    assert counters.get("kd.rebuilds") == 1
    assert torch.equal(out.kd.node_split, scene.kd.node_split)  # the splits of the build, lanes filed again
    verts = out.triangles.verts
    assert bool((out.kd.bounds_max >= verts.amax(dim=(0, 1))).all()) and bool(
        (out.kd.bounds_min <= verts.amin(dim=(0, 1))).all())
    touched = np.isin(faces, pick).any(axis=1) | (faces == top).any(axis=1)
    o, d = _rays_at(verts[torch.from_numpy(touched)].mean(dim=1).numpy(), 512, 6)
    t_max = torch.full((o.shape[0],), 50.0)
    t_ref, i_ref = ttri.edge_sign_brute_closest(verts, o, d)
    hit_ref = t_ref < t_max
    any_ref = ttri.edge_sign_brute_any(verts, o, d, t_max)
    stale = refresh_kd_blocks(scene.kd, verts)
    for kd, name in ((out.kd, "followed"), (stale, "stale")):
        t, idx, hit = kd_closest(kd, out.triangles, o, d, t_max, cfg)
        blocked = kd_any(kd, out.triangles, o, d, t_max, cfg)
        same = torch.equal(hit, hit_ref) and torch.equal(t[hit], t_ref[hit]) and torch.equal(blocked, any_ref)
        assert same == (name == "followed"), name
    # the rebuilt tree stays filed for a small further move: no second rebuild
    profiling.enable()
    try:
        tgrad.follow_moves(out, tgrad.merge_params(out, {LEAF: torch.from_numpy(moved + 1e-4)}))
        assert "kd.rebuilds" not in profiling.take()["counters"]
    finally:
        profiling.disable()


def test_a_moved_soup_is_found_by_every_walk():
    """A soup's tree follows its vertices the same way: ``sgd_step`` on
    'triangles.verts' moving corners across split planes and out of the
    root box rebuilds the tree, and both walks give the hits of the leaf
    test over every triangle."""
    cfg = T.Config(MaxPrims=8, leaf_chunk_lanes=8)
    scene = T.default_scene(seed=0, cfg=cfg, mesh="teapot", num_spheres=1).build(cfg, device="cpu")
    verts = scene.triangles.verts
    rng = np.random.default_rng(8)
    pick = rng.choice(verts.shape[0], 120, replace=False)
    step = np.zeros(verts.shape, np.float32)
    step[pick] = rng.normal(0.0, 0.4, (120, 3, 3))
    step[pick[0], :, 0] += 1.5 + float(verts[:, :, 0].max() - verts[pick[0], :, 0].min())  # out of the root box
    profiling.enable()
    try:
        out = tgrad.sgd_step(scene, {"triangles.verts": torch.from_numpy(-step)}, lr=1.0)
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    assert counters.get("kd.rebuilds") == 1
    assert torch.equal(out.kd.node_flag, scene.kd.node_flag) and torch.equal(out.kd.node_split, scene.kd.node_split)
    moved = out.triangles.verts
    assert bool((out.kd.bounds_max >= moved.amax(dim=(0, 1))).all())
    o, d = _rays_at(moved[torch.from_numpy(pick)].mean(dim=1).numpy(), 512, 9)
    t_max = torch.full((o.shape[0],), 50.0)
    t_ref, _ = ttri.edge_sign_brute_closest(moved, o, d)
    hit_ref = t_ref < t_max
    t, _, hit = kd_closest(out.kd, out.triangles, o, d, t_max, cfg)
    assert torch.equal(hit, hit_ref) and torch.equal(t[hit], t_ref[hit])
    assert torch.equal(kd_any(out.kd, out.triangles, o, d, t_max, cfg), ttri.edge_sign_brute_any(moved, o, d, t_max))


def test_shape_fit_steps_lower_the_loss_and_count_rows(teapot):
    """``train.make_update_fn`` on the positions leaf: the loss falls, the
    tree follows, the counter ``grad.geom.rows`` counts every bounce's
    triangle rows once (not again in the remat recompute)."""
    positions, faces = teapot
    cfg = T.Config(Width=16, Height=12, recursion_depth=2, MaxPrims=96, leaf_chunk_lanes=48, remat_bounces=True)
    scene = welded_scene(positions, faces, cfg)
    target = tgrad.render_for_grad(scene, cfg)
    start = welded_scene(noisy(positions, 3), faces, cfg)
    opt = ttrain.make_optimizer(0.00164)(tgrad.split_float_params(start, [LEAF]))
    update = ttrain.make_update_fn(cfg, [LEAF])
    profiling.enable()
    try:
        losses = []
        for _ in range(4):
            loss, start, opt = update(start, opt, target)
            losses.append(float(loss))
        rec = profiling.take()
    finally:
        profiling.disable()
    assert losses[-1] < losses[0]
    assert rec["counters"]["grad.geom.rows"] == 4 * cfg.recursion_depth * cfg.Width * cfg.Height
    names = {s.name for s in rec["spans"]}
    assert {"mesh.derive", "kd.refresh"} <= names
    assert torch.equal(start.kd.block_tris, refresh_kd_blocks(start.kd, start.triangles.verts).block_tris)


def test_colour_fit_unchanged(teapot):
    """A ``teapot-fit``-style colour fit: its steps equal, bit for bit, a
    plain loop of ``mse_loss`` and ``torch.optim.Adam`` on the same leaves,
    and leave the triangles and the kd tree the same objects (no derive, no
    repack, no counter)."""
    cfg = T.Config(Width=16, Height=12, recursion_depth=2, MaxPrims=96, leaf_chunk_lanes=48, remat_bounces=True)
    scene = T.default_scene(seed=4, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
    target = tgrad.render_for_grad(scene, cfg).detach() * 0.9
    names = ["spheres.color", "mesh_colors", "lights.intensity"]
    opt = ttrain.make_optimizer(0.05)(tgrad.split_float_params(scene, names))
    update = ttrain.make_update_fn(cfg, names)
    leaves = [scene.spheres.color.clone().requires_grad_(True), scene.mesh_colors.clone().requires_grad_(True),
              scene.lights.intensity.clone().requires_grad_(True)]
    plain = torch.optim.Adam(leaves, lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    s = scene
    profiling.enable()
    try:
        for _ in range(2):
            loss, s, opt = update(s, opt, target)
            plain.zero_grad()
            want = tgrad.mse_loss(dataclasses.replace(
                scene, spheres=dataclasses.replace(scene.spheres, color=leaves[0]), mesh_colors=leaves[1],
                lights=dataclasses.replace(scene.lights, intensity=leaves[2])), target, cfg)
            want.backward()
            plain.step()
            assert torch.equal(loss, want.detach())
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    assert torch.equal(s.spheres.color, leaves[0].detach()) and torch.equal(s.lights.intensity, leaves[2].detach())
    assert s.kd is scene.kd and s.triangles is scene.triangles
    assert "grad.geom.rows" not in counters and "kd.rebuilds" not in counters
