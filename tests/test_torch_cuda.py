"""The CUDA kernels (the packet walk and the per-ray walk it replaced, the
mega and forest walks, the binned walk's block-loop leaf stage and its
descend round, the Möller–Trumbore and Plücker brute force and the
per-ray kernels they replaced, the families' any-hit and closest hit) vs
their plain versions, on a CUDA device.

The kernels have no CPU mode, so every test here skips without a card.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:  python -m pytest --noconftest tests/test_torch_cuda.py

Parity rule: the plain walks compute the kernels' leaf test (Plücker
edge signs on block_g, Möller–Trumbore t on block_tris, each operation
in the kernels' order) in the kernels' visit order, so a per-ray kernel
and its plain walk, on the card or on the CPU, give the same bits: hit
masks equal, t and prims equal where both hit.  The packet walk visits
the union of its warp's leaves in its own order, so it is held to the
JAX package's packet rule (tests/test_packet.py), tightened: hit masks
and any-hit bits equal, closest-hit t bit-equal, and a prim may differ
only where both triangles' Möller–Trumbore t are bit-equal
(``ops.packet.parity``).  The mega and forest kernels are the same warp
walk over other node layouts (``csrc/kd_warp.cuh``) and are held to the
same rule, against the plain walks, their per-ray kernels
(``*_per_ray``, bit for bit with the plain walks) and the packet walk on
the same tree.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
import torch_family_rays as R
from dod_raytracer_tpu_torch.mesh import load_mesh_asset, procedural_dragon
from dod_raytracer_tpu_torch.ops import binned, brute, families, forest, mega, mt, packet, plucker
from dod_raytracer_tpu_torch.ops import traverse as ttrav
from dod_raytracer_tpu_torch.ops.triangle import brute_force_closest
from dod_raytracer_tpu_torch.shading import _shadow_perm, shadow_rays

N = 4096
PACKET_WALKS = ["packet", "per_ray"]  # the frame's kernel, the per-ray walk it replaced
WARP_WALKS = ["packet", "mega", "forest"]  # one warp-walk template, three node layouts


def _packet_walk(name):
    """(wrapper, its launch counts) of a walk: 'packet', 'mega', 'forest'
    (the warp walks) or 'per_ray', 'mega_per_ray', 'forest_per_ray' (the
    per-ray kernels they replaced)."""
    return {"packet": (packet.packet_traverse, packet.launches),
            "per_ray": (packet.packet_traverse_per_ray, packet.per_ray_launches),
            "mega": (mega.mega_traverse, mega.launches),
            "mega_per_ray": (mega.mega_traverse_per_ray, mega.per_ray_launches),
            "forest": (forest.forest_traverse, forest.launches),
            "forest_per_ray": (forest.forest_traverse_per_ray, forest.per_ray_launches)}[name]


def assert_walk_parity(name, kd, got, ref, o, d, any_hit):
    """A per-ray walk: every output bit for bit (any-hit: the hit bits);
    a warp walk: the packet rule.  Returns the prim ties."""
    if name.endswith("per_ray") or any_hit:
        assert torch.equal(got[2], ref[2])
        if not any_hit:
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        return 0
    res = packet.parity(kd, got, ref, o, d, any_hit)
    assert packet.parity_holds(res), res
    return res["prim_ties"]


@pytest.fixture(scope="module")
def teapot_kd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tv, tn = load_mesh_asset("teapot")
    cfg = T.Config(MaxPrims=96, leaf_chunk_lanes=48)
    b = T.SceneBuilder()
    b.add_mesh(tv, tn)
    kd = b.build(cfg, device="cuda").kd
    return tv, kd, ttrav._stack_depth(kd, cfg)


def make_rays(case, seed):
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
    t_max[:16] = -1.0
    return [torch.from_numpy(x).cuda() for x in (o, d.astype(np.float32), t_max)]


@pytest.mark.parametrize("walk", PACKET_WALKS)
@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_closest_matches_plain_walk(teapot_kd, case, walk):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays(case, seed=4)
    wrapper, counts = _packet_walk(walk)
    before = counts["closest"]
    got = wrapper(kd, o, d, t_max, depth, False)
    assert counts["closest"] == before + 1
    ref = ttrav.traverse_plain(kd, o, d, t_max, depth, False)
    assert int((ref[2] & (ref[0] < t_max)).sum()) > N // 8
    assert_walk_parity(walk, kd, got, ref, o, d, False)


@pytest.mark.parametrize("walk", PACKET_WALKS)
@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_any_hit_matches_plain_walk(teapot_kd, case, walk):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays(case, seed=5)
    wrapper, counts = _packet_walk(walk)
    before = counts["any_hit"]
    _, _, fk = wrapper(kd, o, d, t_max, depth, True)
    assert counts["any_hit"] == before + 1
    _, _, fp = ttrav.traverse_plain(kd, o, d, t_max, depth, True)
    np.testing.assert_array_equal(fk.cpu().numpy(), fp.cpu().numpy())


@pytest.mark.parametrize("walk", PACKET_WALKS)
def test_wrapper_rejects_bad_inputs(teapot_kd, walk):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    wrapper, counts = _packet_walk(walk)
    before = dict(counts)
    with pytest.raises(TypeError):
        wrapper(kd, o.double(), d, t_max, depth, False)
    with pytest.raises(ValueError):
        wrapper(kd, o[:, :2].contiguous(), d, t_max, depth, False)
    with pytest.raises(ValueError):
        wrapper(kd, o, d, t_max, 65, False)
    if walk == "packet":
        with pytest.raises(ValueError, match="stack"):  # the warp's stack may not drop an entry
            wrapper(kd, o, d, t_max, kd.max_depth - 1, False)
        with pytest.raises(ValueError, match="stack"):  # nor can it size a tree of unknown depth
            wrapper(dataclasses.replace(kd, max_depth=0), o, d, t_max, depth, False)
    assert counts == before


@pytest.mark.parametrize("walk", PACKET_WALKS)
def test_wrapper_rejects_missing_kd_tables(teapot_kd, walk):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    wrapper, counts = _packet_walk(walk)
    before = dict(counts)
    for name in ("block_g", "block_aabb", "block_tris", "block_orig"):
        with pytest.raises(ValueError, match=name):
            wrapper(dataclasses.replace(kd, **{name: None}), o, d, t_max, depth, False)
    assert counts == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_build_gives_the_same_result(teapot_kd, any_hit):
    """Both walks' measurement builds give their render builds' outputs;
    the per-ray counts agree with its marks, the packet counts are
    consistent."""
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("clipped", seed=7)
    ref = packet.packet_traverse_per_ray(kd, o, d, t_max, depth, any_hit)
    stats, touched = _stats_outputs(kd)
    got = packet.packet_traverse_per_ray(kd, o, d, t_max, depth, any_hit, stats=stats, touched=touched)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    _check_stats(kd, stats, touched, aabb=True)
    with pytest.raises(ValueError, match="stats"):
        packet.packet_traverse_per_ray(kd, o, d, t_max, depth, any_hit, touched=touched)
    ref = packet.packet_traverse(kd, o, d, t_max, depth, any_hit)
    wstats = torch.zeros(((N + 31) // 32, len(packet.STATS)), dtype=torch.int32, device="cuda")
    got = packet.packet_traverse(kd, o, d, t_max, depth, any_hit, stats=wstats)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    steps, staged, wanting, _, distances = wstats.long().sum(0).tolist()
    assert steps > 0 and staged > 0 and 0 < wanting <= 32 * staged and distances > 0
    with pytest.raises(ValueError, match="stats"):
        packet.packet_traverse(kd, o, d, t_max, depth, any_hit, stats=stats)  # the per-ray shape


def _stats_outputs(kd):
    B, S = kd.block_orig.shape
    return (torch.zeros((N, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((B, 2 + S), dtype=torch.int32, device="cuda"))


def _check_stats(kd, stats, touched, aabb):
    """The measurement build's counts agree with its marks."""
    steps, blocks, slots, distances = stats.long().sum(0).tolist()
    valid_per_block = int((kd.block_orig >= 0).sum(1).max())
    assert steps > 0 and blocks > 0 and 0 < slots <= blocks * valid_per_block
    assert 0 < distances <= slots
    marks = touched.bool()
    edge_blocks = int(marks[:, 1].sum())
    assert 0 < edge_blocks <= blocks
    assert 0 < int(marks[:, 2:].sum()) <= distances
    assert not (marks[:, 2:].any(1) & ~marks[:, 1]).any()  # a slot read lies in an edge-tested block
    assert not (marks[:, 2:] & (kd.block_orig < 0)).any()  # empty slots never pass the edge signs
    if aabb:
        assert not (marks[:, 1] & ~marks[:, 0]).any()  # edge-tested blocks had their AABB read
    else:
        assert not marks[:, 0].any()


@pytest.fixture(scope="module")
def dragon_kd():
    """The 40k-triangle dragon (MaxPrims=32, leaf_chunk_lanes=32: blocks of
    256 slots, a deeper tree than the teapot's), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tv, tn = procedural_dragon(40000)
    cfg = T.Config(MaxPrims=32, leaf_chunk_lanes=32)
    b = T.SceneBuilder()
    b.add_mesh(tv, tn)
    kd = b.build(cfg, device="cuda").kd
    return tv, kd, ttrav._stack_depth(kd, cfg)


def edge_rays(tv, kd, case, seed, n=N):
    """Rays of one hard case for the packet walk, on the card:
    'incoherent': origins inside the mesh bounds, random directions, so a
    warp's 32 walks share little; 'split_planes': origins exactly on
    interior nodes' split planes, half of them also parallel to that axis
    (t_plane and the AABB slabs NaN); 'dead_tail': rays aimed at the mesh
    with a third killed (t_max = -1) and moved to the tail, as sort_shadow
    leaves them."""
    rng = np.random.default_rng(seed)
    lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    t_max = np.full((n,), np.inf, np.float32)
    if case == "split_planes":
        flag = kd.node_flag.cpu().numpy()
        split = kd.node_split.cpu().numpy()
        interior = np.nonzero(flag < 3)[0]
        pick = interior[rng.integers(0, interior.shape[0], n)]
        axis = flag[pick]
        o[np.arange(n), axis] = split[pick]
        flat = np.arange(n) % 2 == 0
        d[flat, axis[flat]] = 0.0
    elif case == "dead_tail":
        o = (lo - 0.5 * (hi - lo) + rng.random((n, 3)) * 2 * (hi - lo)).astype(np.float32)
        aim = tv[rng.integers(0, tv.shape[0], n)].mean(axis=1)
        d = (aim - o).astype(np.float32)
        t_max[n - n // 3:] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (o, d.astype(np.float32), t_max)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["incoherent", "split_planes", "dead_tail"])
@pytest.mark.parametrize("scene", ["teapot", "dragon"])
def test_packet_walk_hard_cases(teapot_kd, dragon_kd, scene, case, any_hit):
    """The packet walk against the plain walk and the per-ray kernel, on
    ray counts that are not a multiple of 32 and below 32."""
    tv, kd, depth = teapot_kd if scene == "teapot" else dragon_kd
    o, d, t_max = edge_rays(tv, kd, case, seed=21)
    hits = 0
    for n in (N - 7, 5):
        ro, rd, rt = (x[:n].contiguous() for x in (o, d, t_max))
        ref = ttrav.traverse_plain(kd, ro, rd, rt, depth, any_hit)
        per_ray = packet.packet_traverse_per_ray(kd, ro, rd, rt, depth, any_hit)
        assert torch.equal(per_ray[2], ref[2])
        hits += int(ref[2].sum())
        got = packet.packet_traverse(kd, ro, rd, rt, depth, any_hit)
        assert_walk_parity("packet", kd, got, ref, ro, rd, any_hit)
        if case == "dead_tail":
            dead = rt < 0
            assert not got[2][dead].any() and torch.equal(got[0][dead], rt[dead])
    assert hits > 0


@pytest.mark.parametrize("sort", [False, True])
def test_packet_walk_shadow_batches(teapot_kd, dragon_kd, sort):
    """Any-hit on a batch of shadow rays (3 lights, pairs killed at
    random), unsorted and sorted per light by hit-point Morton code
    (``sort_shadow``), against the per-ray kernel and the plain walk."""
    import types

    for tv, kd, depth in (teapot_kd, dragon_kd):
        o, d, t_max = edge_rays(tv, kd, "dead_tail", seed=22, n=2048)
        t, _, found = packet.packet_traverse_per_ray(kd, o, d, t_max, depth, False)
        points = (o + d * torch.where(found, t, 0.0)[:, None])[found]
        rng = np.random.default_rng(23)
        lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
        lights = torch.from_numpy((lo + (rng.random((3, 3)) * 3 - 1) * (hi - lo)).astype(np.float32)).cuda()
        relevant = torch.from_numpy(rng.random((points.shape[0], 3)) > 0.2).cuda()
        so, sd, st = shadow_rays(types.SimpleNamespace(lights=types.SimpleNamespace(position=lights)),
                                 points, relevant=relevant)
        if sort:
            perm = _shadow_perm(types.SimpleNamespace(kd=kd), so, sd, st, 3)
            so, sd, st = so[perm], sd[perm], st[perm]
        so, sd, st = so.contiguous(), sd.contiguous(), st.contiguous()
        got = packet.packet_traverse(kd, so, sd, st, depth, True)
        per_ray = packet.packet_traverse_per_ray(kd, so, sd, st, depth, True)
        plain = ttrav.traverse_plain(kd, so, sd, st, depth, True)
        assert bool(plain[2].any()) and not bool(plain[2].all())
        assert torch.equal(got[2], per_ray[2]) and torch.equal(got[2], plain[2])


@pytest.fixture(scope="module")
def forest_kd():
    """The teapot cut into a forest (treelet_cap=16: several treelets
    and a real top tree), on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tv, tn = load_mesh_asset("teapot")
    cfg = T.Config(MaxPrims=96, leaf_chunk_lanes=48, treelet_cap=16)
    b = T.SceneBuilder()
    b.add_mesh(tv, tn)
    kd = b.build(cfg, device="cuda").kd
    assert kd.tre_tbl is not None and kd.tre_tbl.shape[0] > 1
    return tv, kd, ttrav._stack_depth(kd, cfg)


def _walks(teapot_kd, forest_kd, per_ray=False):
    """(name, wrapper, its launch counts, kd, depth, its plain walk) of the
    mega and forest warp walks, or of their per-ray kernels."""
    _, kd, depth = teapot_kd
    _, fkd, fdepth = forest_kd
    suffix = "_per_ray" if per_ray else ""
    return [(f"mega{suffix}", *_packet_walk(f"mega{suffix}"), kd, depth, ttrav.traverse_plain),
            (f"forest{suffix}", *_packet_walk(f"forest{suffix}"), fkd, fdepth, ttrav.traverse_forest_plain)]


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_kernels_match_plain_walks(teapot_kd, forest_kd, case, any_hit):
    """The mega and forest per-ray kernels vs their plain walks and vs the
    per-ray packet kernel (the same leaf test and visit order), bit for
    bit; the mega and forest warp walks vs all of them, and vs the packet
    walk on the same tree, under the packet rule."""
    o, d, t_max = make_rays(case, seed=8)
    mode = "any_hit" if any_hit else "closest"
    for (name, walk, counts, kd, depth, plain), (wname, wwalk, wcounts, _, _, _) in zip(
            _walks(teapot_kd, forest_kd, per_ray=True), _walks(teapot_kd, forest_kd)):
        before, wbefore = counts[mode], wcounts[mode]
        tk, pk, fk = walk(kd, o, d, t_max, depth, any_hit)
        assert counts[mode] == before + 1, name
        tp, pp, fp = plain(kd, o, d, t_max, depth, any_hit)
        tq, pq, fq = packet.packet_traverse_per_ray(kd, o, d, t_max, depth, any_hit)
        assert torch.equal(fk, fp) and torch.equal(fk, fq), name
        if not any_hit:
            hit = fp & (tp < t_max)
            assert int(hit.sum()) > N // 8
            assert torch.equal(tk[hit], tp[hit]) and torch.equal(pk[hit], pp[hit]), name
            assert torch.equal(tk, tq) and torch.equal(pk, pq), name
        got = wwalk(kd, o, d, t_max, depth, any_hit)
        assert wcounts[mode] == wbefore + 1, wname
        for ref in ((tp, pp, fp), (tk, pk, fk), packet.packet_traverse(kd, o, d, t_max, depth, any_hit)):
            assert_walk_parity(wname, kd, got, ref, o, d, any_hit)
        assert_walk_parity("packet", kd, packet.packet_traverse(kd, o, d, t_max, depth, any_hit),
                           (tk, pk, fk), o, d, any_hit)


def _hard_case_tree(name, teapot_kd, forest_kd, dragon_kd, tree):
    """The tree a hard-case test of warp walk ``name`` runs on: 'small' is
    the teapot (mega) or its forest of 16-row treelets (forest), 'dragon'
    the 40k dragon (its treelet tables for the forest)."""
    if tree == "dragon":
        assert dragon_kd[1].tre_tbl is not None
        return dragon_kd
    return forest_kd if name == "forest" else teapot_kd


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["incoherent", "split_planes", "dead_tail"])
@pytest.mark.parametrize("tree", ["small", "dragon"])
@pytest.mark.parametrize("name", ["mega", "forest"])
def test_warp_walks_hard_cases(teapot_kd, forest_kd, dragon_kd, name, tree, case, any_hit):
    """The mega and forest warp walks against their plain walks, their
    per-ray kernels and the packet walk on the same tree, on ray counts
    that are not a multiple of 32 and below 32; the per-ray kernels bit for
    bit against the plain walks.  On the forests, warps pop back across
    treelets."""
    tv, kd, depth = _hard_case_tree(name, teapot_kd, forest_kd, dragon_kd, tree)
    plain = ttrav.traverse_forest_plain if name == "forest" else ttrav.traverse_plain
    walk, per_ray_walk = _packet_walk(name)[0], _packet_walk(f"{name}_per_ray")[0]
    o, d, t_max = edge_rays(tv, kd, case, seed=24)
    hits = 0
    for n in (N - 7, 5):
        ro, rd, rt = (x[:n].contiguous() for x in (o, d, t_max))
        ref = plain(kd, ro, rd, rt, depth, any_hit)
        per_ray = per_ray_walk(kd, ro, rd, rt, depth, any_hit)
        assert_walk_parity(f"{name}_per_ray", kd, per_ray, ref, ro, rd, any_hit)
        hits += int(ref[2].sum())
        got = walk(kd, ro, rd, rt, depth, any_hit)
        for other in (ref, per_ray, packet.packet_traverse(kd, ro, rd, rt, depth, any_hit)):
            assert_walk_parity(name, kd, got, other, ro, rd, any_hit)
        if case == "dead_tail":
            dead = rt < 0
            assert not got[2][dead].any() and torch.equal(got[0][dead], rt[dead])
    assert hits > 0


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("name", ["mega", "forest"])
def test_warp_walks_shadow_batches(teapot_kd, forest_kd, dragon_kd, name, sort):
    """The shadow batches of ``test_packet_walk_shadow_batches`` through
    the mega and forest warp walks, against their per-ray kernels, the
    plain walks and the packet walk."""
    import types

    small = forest_kd if name == "forest" else teapot_kd
    plain = ttrav.traverse_forest_plain if name == "forest" else ttrav.traverse_plain
    walk, per_ray_walk = _packet_walk(name)[0], _packet_walk(f"{name}_per_ray")[0]
    for tv, kd, depth in (small, dragon_kd):
        o, d, t_max = edge_rays(tv, kd, "dead_tail", seed=22, n=2048)
        t, _, found = per_ray_walk(kd, o, d, t_max, depth, False)
        points = (o + d * torch.where(found, t, 0.0)[:, None])[found]
        rng = np.random.default_rng(23)
        lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
        lights = torch.from_numpy((lo + (rng.random((3, 3)) * 3 - 1) * (hi - lo)).astype(np.float32)).cuda()
        relevant = torch.from_numpy(rng.random((points.shape[0], 3)) > 0.2).cuda()
        so, sd, st = shadow_rays(types.SimpleNamespace(lights=types.SimpleNamespace(position=lights)),
                                 points, relevant=relevant)
        if sort:
            perm = _shadow_perm(types.SimpleNamespace(kd=kd), so, sd, st, 3)
            so, sd, st = so[perm], sd[perm], st[perm]
        so, sd, st = so.contiguous(), sd.contiguous(), st.contiguous()
        got = walk(kd, so, sd, st, depth, True)
        refs = [per_ray_walk(kd, so, sd, st, depth, True), plain(kd, so, sd, st, depth, True),
                packet.packet_traverse(kd, so, sd, st, depth, True)]
        assert bool(refs[1][2].any()) and not bool(refs[1][2].all())
        for ref in refs:
            assert torch.equal(got[2], ref[2])


def test_dispatch_raises_on_missing_tables(teapot_kd):
    """A CUDA tree without block_g (or block_aabb, for the warp walks)
    reaches its kernel's wrapper through the dispatch, and that raises: no
    backend gives way to a torch walk on the card."""
    _, kd, _ = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    before = [dict(m.launches) for m in (packet, mega, forest, binned)]
    for name in ("auto", "packet", "mega", "forest", "binned"):
        cfg = T.Config(MaxPrims=96, leaf_chunk_lanes=48, traversal_backend=name)
        for table in ("block_g",) + (("block_aabb",) if name != "binned" else ()):
            with pytest.raises(ValueError, match=table):
                ttrav.kd_closest(dataclasses.replace(kd, **{table: None}), None, o, d, t_max, cfg)
    assert [dict(m.launches) for m in (packet, mega, forest, binned)] == before


def test_walk_wrappers_reject_missing_tables(teapot_kd, forest_kd):
    o, d, t_max = make_rays("unclipped", seed=6)
    modules = (mega, forest)
    before = [(dict(m.launches), dict(m.per_ray_launches)) for m in modules]
    for per_ray in (False, True):
        for name, walk, _, kd, depth, _ in _walks(teapot_kd, forest_kd, per_ray):
            tables = ["block_g", "block_tris", "block_orig"] + (["tre_tbl", "top_tbl"] if "forest" in name else [])
            tables += [] if per_ray else ["block_aabb"]  # the per-ray walks have no AABB pre-test
            for table in tables:
                with pytest.raises(ValueError, match=table):
                    walk(dataclasses.replace(kd, **{table: None}), o, d, t_max, depth, False)
    assert [(dict(m.launches), dict(m.per_ray_launches)) for m in modules] == before


@pytest.mark.parametrize("name", WARP_WALKS)
def test_warp_walks_refuse_what_they_cannot_hold(teapot_kd, forest_kd, name):
    """Each warp walk refuses, before any launch, a stack shallower than
    the tree, a tree of unknown depth, staged blocks over the 227 KB of
    shared memory a CTA may use (spad 512: 8 x 18 x 512 floats), and the
    per-ray stats shape."""
    _, kd, depth = forest_kd if name == "forest" else teapot_kd
    walk, counts = _packet_walk(name)
    o, d, t_max = make_rays("unclipped", seed=6)
    before = dict(counts)
    with pytest.raises(ValueError, match="stack"):
        walk(kd, o, d, t_max, kd.max_depth - 1, False)
    with pytest.raises(ValueError, match="stack"):
        walk(dataclasses.replace(kd, max_depth=0), o, d, t_max, depth, False)
    B = kd.block_g.shape[0]
    wide = torch.zeros((B, 16, 5 * 512), dtype=torch.float32, device="cuda")
    assert packet.smem_bytes(512) > packet.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        walk(dataclasses.replace(kd, block_g=wide), o, d, t_max, depth, False)
    with pytest.raises(ValueError, match="stats"):
        walk(kd, o, d, t_max, depth, False, stats=torch.zeros((N, 4), dtype=torch.int32, device="cuda"))
    assert counts == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_stats_build_gives_the_same_result(teapot_kd, forest_kd, any_hit):
    """The mega and forest kernels' measurement builds give their render
    builds' outputs: the per-ray walks' counts agree with their marks, the
    warp walks' counts add up."""
    o, d, t_max = make_rays("clipped", seed=9)
    for name, walk, _, kd, depth, _ in _walks(teapot_kd, forest_kd, per_ray=True):
        ref = walk(kd, o, d, t_max, depth, any_hit)
        stats, touched = _stats_outputs(kd)
        got = walk(kd, o, d, t_max, depth, any_hit, stats=stats, touched=touched)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), name
        _check_stats(kd, stats, touched, aabb=False)
    for name, walk, _, kd, depth, _ in _walks(teapot_kd, forest_kd):
        ref = walk(kd, o, d, t_max, depth, any_hit)
        wstats = torch.zeros(((N + 31) // 32, len(packet.STATS)), dtype=torch.int32, device="cuda")
        got = walk(kd, o, d, t_max, depth, any_hit, stats=wstats)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), name
        steps, staged, wanting, _, distances = wstats.long().sum(0).tolist()
        assert steps > 0 and staged > 0 and 0 < wanting <= 32 * staged and distances > 0, name
        # the same walk over another layout of the same tree stages the same blocks
        pstats = torch.zeros_like(wstats)
        packet.packet_traverse(kd, o, d, t_max, depth, any_hit, stats=pstats)
        assert torch.equal(wstats, pstats), name


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernels_match_plain_walks_on_the_cpu(teapot_kd, forest_kd, any_hit):
    """Every kernel on the card against its plain walk on the CPU, on the
    same tables and rays: the per-ray kernels bit for bit, the warp walks
    under the packet rule."""
    o, d, t_max = make_rays("clipped", seed=10)
    cpu = lambda x: x.cpu()
    walks = [(name, _packet_walk(name)[0], *teapot_kd[1:], ttrav.traverse_plain) for name in PACKET_WALKS]
    for per_ray in (False, True):
        walks += [(name, walk, kd, depth, plain)
                  for name, walk, _, kd, depth, plain in _walks(teapot_kd, forest_kd, per_ray)]
    for name, walk, kd, depth, plain in walks:
        kd_cpu = dataclasses.replace(kd, **{f.name: cpu(getattr(kd, f.name)) for f in dataclasses.fields(kd)
                                            if isinstance(getattr(kd, f.name), torch.Tensor)})
        got = walk(kd, o, d, t_max, depth, any_hit)
        ref = plain(kd_cpu, cpu(o), cpu(d), cpu(t_max), depth, any_hit)
        assert bool(ref[2].any()), name
        assert torch.equal(got[2].cpu(), ref[2]), name
        if name in WARP_WALKS:
            assert_walk_parity(name, kd, got, [x.cuda() for x in ref], o, d, any_hit)
        elif not any_hit:
            for a, b in zip(got[:2], ref[:2]):
                assert torch.equal(a.cpu(), b), name


def _cpu_kd(kd):
    return dataclasses.replace(kd, **{f.name: getattr(kd, f.name).cpu() for f in dataclasses.fields(kd)
                                      if isinstance(getattr(kd, f.name), torch.Tensor)})


def _keys(tv, kd, o, d, seed):
    """A block key per ray: a block that holds the triangle the ray meets
    first, or a random block for a ray that misses and for a quarter of
    the rays, and a key >= B for an eighth."""
    rng = np.random.default_rng(seed)
    orig = kd.block_orig.cpu().numpy()
    B = orig.shape[0]
    block_of = np.zeros(tv.shape[0], np.int64)
    blk, slot = np.nonzero(orig >= 0)
    block_of[orig[blk, slot]] = blk
    t, idx = (x.cpu().numpy() for x in brute_force_closest(torch.from_numpy(tv).cuda(), o, d))
    keys = np.where(np.isfinite(t), block_of[idx], rng.integers(0, B, N))
    keys[N // 8:N // 4] = rng.integers(0, B, N // 8)
    keys[:N // 8] = B + rng.integers(0, 3, N // 8)
    return torch.from_numpy(keys.astype(np.int32)).cuda()


def test_block_loop_matches_its_plain_version_on_the_cpu(teapot_kd):
    tv, kd, _ = teapot_kd
    o, d, _ = make_rays("unclipped", seed=11)
    keys = _keys(tv, kd, o, d, 11)
    before = binned.launches["any_hit"]
    t, p = binned.block_loop_intersect(kd, o, d, keys, "any_hit")
    assert binned.launches["any_hit"] == before + 1
    t_ref, p_ref = ttrav.leaf_plain(_cpu_kd(kd), o.cpu(), d.cpu(), keys.cpu())
    assert int(torch.isfinite(t_ref).sum()) > N // 8
    assert torch.equal(t.cpu(), t_ref) and torch.equal(p.cpu(), p_ref)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_walk_matches_plain_walks(teapot_kd, any_hit):
    """The binned walk on the card against the plain walk on the card and
    on the CPU, bit for bit in every output and both modes, and against
    the packet kernel.  An any-hit ray's t and prim are compared with the
    plain walks only: the binned walk and the plain walks take the closest
    hit of the block where a ray first hits, the per-ray kernels
    (kd_leaf.cuh test_block<kAnyHit>) stop at that block's first hit slot."""
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("clipped", seed=12)
    mode = "any_hit" if any_hit else "closest"
    before = binned.launches[mode]
    got = binned.binned_traverse(kd, o, d, t_max, depth, any_hit)
    assert binned.launches[mode] > before
    plains = [ttrav.traverse_plain(kd, o, d, t_max, depth, any_hit),
              ttrav.traverse_plain(_cpu_kd(kd), o.cpu(), d.cpu(), t_max.cpu(), depth, any_hit)]
    assert bool(plains[0][2].any())
    for ref in plains:
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b.cpu())
    pk = packet.packet_traverse_per_ray(kd, o, d, t_max, depth, any_hit)
    assert torch.equal(got[2], pk[2])
    if not any_hit:
        assert torch.equal(got[0], pk[0]) and torch.equal(got[1], pk[1])
    assert_walk_parity("packet", kd, packet.packet_traverse(kd, o, d, t_max, depth, any_hit), got, o, d, any_hit)


def test_block_loop_stats_build_gives_the_same_result(teapot_kd):
    tv, kd, _ = teapot_kd
    o, d, _ = make_rays("unclipped", seed=13)
    keys = _keys(tv, kd, o, d, 13)
    ref = binned.block_loop_intersect(kd, o, d, keys)
    B, S = kd.block_orig.shape
    stats = torch.zeros((N, 2), dtype=torch.int32, device="cuda")
    touched = torch.zeros((B, 2 + S), dtype=torch.int32, device="cuda")
    got = binned.block_loop_intersect(kd, o, d, keys, stats=stats, touched=touched)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    valid = keys < B
    slots, distances = stats.long().sum(0).tolist()
    per_block = (kd.block_orig >= 0).sum(1)
    assert slots == int(per_block[keys[valid].long()].sum())  # every non-empty slot of the keyed block
    assert 0 < distances <= slots
    assert not stats[~valid].any()
    marks = touched.bool()
    assert torch.equal(marks[:, 1], torch.isin(torch.arange(B, device="cuda"), keys[valid]))
    assert not (marks[:, 2:] & (kd.block_orig < 0)).any()
    with pytest.raises(ValueError, match="stats"):
        binned.block_loop_intersect(kd, o, d, keys, touched=touched)


def test_block_loop_wrappers_reject_bad_inputs(teapot_kd):
    tv, kd, depth = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    keys = _keys(tv, kd, o, d, 6)
    before = dict(binned.launches)
    with pytest.raises(TypeError):
        binned.block_loop_intersect(kd, o, d, keys.long())
    with pytest.raises(ValueError):
        binned.block_loop_intersect(kd, o, d, keys[:-1].contiguous())
    with pytest.raises(ValueError):
        binned.block_loop_intersect(kd, o, d, keys, "shadow")
    for table in ("block_g", "block_tris", "block_orig"):
        with pytest.raises(ValueError, match=table):
            binned.binned_traverse(dataclasses.replace(kd, **{table: None}), o, d, t_max, depth, False)
    assert binned.launches == before


BLOCK_LOOP_CASES = ["same", "warp32", "many", "idle", "ragged"]


def _pattern_rays(tv, kd, case, seed):
    """Rays and keys for the block loop's key patterns: every key the same
    ("same"); 32 distinct keys in every warp ("warp32"); random keys, more
    distinct ones a CTA than its ring holds ("many"); random keys with -1
    and keys >= B among them ("idle"); and "many" on a ray count that is
    not a multiple of the CTA or the warp ("ragged").  A ray with a key in
    [0, B) is aimed at a triangle of its block, so most of them hit it."""
    rng = np.random.default_rng(seed)
    orig = kd.block_orig.cpu().numpy()
    B = orig.shape[0]
    full = np.nonzero((orig >= 0).any(1))[0]
    n = N - 77 if case == "ragged" else N
    if case == "same":
        keys = np.full(n, full[len(full) // 2])
    elif case == "warp32":
        keys = np.concatenate([full[(np.arange(32) + w) % len(full)] for w in range(n // 32)])
    else:
        keys = rng.integers(0, B, n)
    if case == "idle":
        keys[rng.random(n) < 1 / 3] = -1
        big = rng.random(n) < 1 / 6
        keys[big] = B + rng.integers(0, 3, int(big.sum()))
        keys[:3] = [-(2**31), 2**31 - 1, B]
    o = ((rng.random((n, 3)) * 2 - 1) * 6.0).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    for i in np.nonzero((keys >= 0) & (keys < B))[0]:
        tri = orig[keys[i]][orig[keys[i]] >= 0]
        if tri.size:
            d[i] = tv[rng.choice(tri)].mean(axis=0) - o[i]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).cuda(), torch.from_numpy(d.astype(np.float32)).cuda(),
            torch.from_numpy(keys.astype(np.int32)).cuda())


def _distinct_keys(keys, B, group):
    """(groups with a key in [0, B), distinct such keys summed over the
    groups) over runs of ``group`` consecutive rays."""
    k = keys.cpu().numpy()
    k = np.where((k >= 0) & (k < B), k, -1)
    sets = [set(k[s:s + group].tolist()) - {-1} for s in range(0, k.size, group)]
    return sum(1 for x in sets if x), sum(len(x) for x in sets)


@pytest.mark.parametrize("case", BLOCK_LOOP_CASES)
def test_block_loop_key_patterns(teapot_kd, case):
    """The block loop against its plain version (on the card and on the
    CPU) and the per-ray kernel it replaced, bit for bit;
    its measurement build gives the same outputs, the per-ray kernel's
    counts and marks, and the distinct keys per warp and per CTA."""
    tv, kd, _ = teapot_kd
    o, d, keys = _pattern_rays(tv, kd, case, seed=BLOCK_LOOP_CASES.index(case))
    B, S = kd.block_orig.shape
    before = binned.launches["closest"]
    got = binned.block_loop_intersect(kd, o, d, keys)
    assert binned.launches["closest"] == before + 1
    valid = (keys >= 0) & (keys < B)
    assert int(torch.isfinite(got[0]).sum()) > int(valid.sum()) // 4
    refs = {"plain": ttrav.leaf_plain(kd, o, d, keys),
            "plain_cpu": ttrav.leaf_plain(_cpu_kd(kd), o.cpu(), d.cpu(), keys.cpu()),
            "per_ray": binned.block_loop_per_ray(kd, o, d, keys)}
    for name, ref in refs.items():
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b.cpu()), name
    assert not torch.isfinite(got[0][~valid]).any() and bool((got[1][~valid] == 2**30).all())
    stats = torch.zeros((keys.shape[0], 2), dtype=torch.int32, device="cuda")
    touched = torch.zeros((B, 2 + S), dtype=torch.int32, device="cuda")
    counts = torch.zeros((len(binned.KEY_COUNTS),), dtype=torch.int32, device="cuda")
    for a, b in zip(binned.block_loop_intersect(kd, o, d, keys, stats=stats, touched=touched, key_counts=counts),
                    got):
        assert torch.equal(a, b)
    rstats, rtouched = torch.zeros_like(stats), torch.zeros_like(touched)
    binned.block_loop_per_ray(kd, o, d, keys, stats=rstats, touched=rtouched)
    assert torch.equal(stats, rstats) and torch.equal(touched, rtouched)
    assert counts.tolist() == [*_distinct_keys(keys, B, 32), *_distinct_keys(keys, B, 256)]


def _recording_leaf(rounds):
    def leaf(kd, o, d, keys):
        rounds.append((o.clone(), keys.clone()))
        return ttrav.leaf_plain(kd, o, d, keys)
    return leaf


@pytest.mark.parametrize("any_hit", [False, True])
def test_descend_rounds_match_the_plain_walk(teapot_kd, any_hit):
    """The round kernel against its plain version on the card: the whole
    state after every round equal, on a batch with idle rays; each round's
    keys those of traverse._walk's same round (its leaf stage recorded);
    the device-round walk's outputs the plain walk's, with one block-loop
    launch and one descend launch a round."""
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("clipped", seed=14)
    mode = "any_hit" if any_hit else "closest"
    walk_rounds = []
    ref = ttrav._walk(kd, o, d, t_max, depth, any_hit, False, _recording_leaf(walk_rounds))
    nodes = ttrav._pack_nodes(kd)
    st, inv_d = binned.init_state(kd, o, d, t_max, depth)
    t_leaf = prim_leaf = None
    rnd = 0
    while True:
        plain = st.clone()
        before = binned.descend_launches[mode]
        binned.descend(kd, nodes, o, d, inv_d, t_max, st, t_leaf, prim_leaf, rnd, any_hit)
        assert binned.descend_launches[mode] == before + 1
        binned.descend_plain(kd, nodes, o, d, inv_d, t_max, plain, t_leaf, prim_leaf, rnd, any_hit)
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(st, f.name), getattr(plain, f.name)), (rnd, f.name)
        work = st.keys >= 0
        if rnd < len(walk_rounds):
            assert torch.equal(o[work], walk_rounds[rnd][0]) and torch.equal(st.keys[work], walk_rounds[rnd][1])
        else:
            assert not work.any()
        t_leaf, prim_leaf = binned.block_loop_intersect(kd, o, d, st.keys, mode)
        if int(st.counts[rnd % 2]) == 0:
            break
        rnd += 1
    # the walk ends in the round whose descend or fold leaves no ray active
    assert len(walk_rounds) - 1 <= rnd <= len(walk_rounds) and rnd > 1
    for a, b in zip((st.t_best, st.prim, st.found.bool()), ref):
        assert torch.equal(a, b)
    loops, descends = binned.launches[mode], binned.descend_launches[mode]
    got = binned.binned_traverse(kd, o, d, t_max, depth, any_hit)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert binned.launches[mode] - loops == binned.descend_launches[mode] - descends == rnd + 1


@pytest.fixture(scope="module")
def brute_inputs():
    """The teapot's triangles and rays, half of them aimed at a triangle,
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tv, _ = load_mesh_asset("teapot")
    o, d, _ = make_rays("unclipped", seed=14)
    return torch.from_numpy(tv).cuda(), o, d


BRUTE = {  # kernel -> (its module, the packing, its plain version, the wrapper, the per-ray kernel)
    "mt": (mt, mt.swizzle_tris, mt.mt_closest_plain, mt.mt_closest, mt.mt_closest_per_ray),
    "plucker": (plucker, plucker.plucker_pack, plucker.plucker_closest_plain, plucker.plucker_closest,
                plucker.plucker_closest_per_ray),
}


@pytest.mark.parametrize("kernel", ["mt", "plucker"])
def test_brute_kernels_match_their_plain_versions(brute_inputs, kernel):
    """Each brute-force kernel on the card against its plain version on
    the card and on the CPU and the per-ray kernel it replaced, bit for
    bit; Möller–Trumbore also against the torch brute force."""
    verts, o, d = brute_inputs
    module, pack, plain, wrapper, per_ray = BRUTE[kernel]
    g = pack(verts)
    assert torch.equal(g.cpu(), pack(verts.cpu()))  # the packing is the same bits on both devices
    before = module.launches["closest"]
    got = wrapper(g, o, d)
    assert module.launches["closest"] == before + 1
    refs = [plain(g, o, d), plain(g.cpu(), o.cpu(), d.cpu()), per_ray(g, o, d)]
    if kernel == "mt":
        refs.append(brute_force_closest(verts, o, d))
    assert int(torch.isfinite(refs[0][0]).sum()) > N // 4
    for ref in refs:
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b.cpu())


def test_brute_wrappers_reject_bad_inputs(brute_inputs):
    verts, o, d = brute_inputs
    before = [dict(m.launches) for m in (mt, plucker)] + [dict(m.per_ray_launches) for m in (mt, plucker)]
    soa, g = mt.swizzle_tris(verts), plucker.plucker_pack(verts)
    for wrapper, packed, cut in ((mt.mt_closest, soa, soa[:, :100]), (plucker.plucker_closest, g, g[..., :100]),
                                 (mt.mt_closest_per_ray, soa, soa[:, :100]),
                                 (plucker.plucker_closest_per_ray, g, g[..., :100])):
        with pytest.raises(ValueError):
            wrapper(cut.contiguous(), o, d)  # not a multiple of the triangle tile
        with pytest.raises(ValueError):
            wrapper(packed.cpu(), o, d)
        with pytest.raises(TypeError):
            wrapper(packed, o.double(), d)
        with pytest.raises(ValueError):
            wrapper(packed, o[:, :2].contiguous(), d)
    for wrapper, packed in ((mt.mt_closest, soa), (plucker.plucker_closest, g)):
        for count in (0, packed.shape[-1] // brute.TILE + 1):
            with pytest.raises(ValueError, match="splits"):
                wrapper(packed, o, d, splits=count)
        with pytest.raises(TypeError):
            wrapper(packed, o, d, stats=torch.zeros((2, 4), dtype=torch.int32, device="cuda"))
        with pytest.raises(ValueError):
            wrapper(packed, o, d, stats=torch.zeros((2, 3), dtype=torch.int64, device="cuda"))
    after = [dict(m.launches) for m in (mt, plucker)] + [dict(m.per_ray_launches) for m in (mt, plucker)]
    assert after == before


BRUTE_CASES = ["tie", "n1", "n5", "n255", "n257", "n16384", "n65536", "miss", "zero_dir", "inside", "dragon"]


@pytest.fixture(scope="module")
def brute_meshes():
    """The teapot and the 40k-triangle dragon, (T, 3, 3) float32 numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return load_mesh_asset("teapot")[0], procedural_dragon(40000)[0]


def _aimed(tv, n, rng, lo=-6.0, hi=6.0):
    """n rays from a box, the first half aimed at triangle centroids."""
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    aim = tv[rng.integers(0, tv.shape[0], n // 2)].mean(axis=1)
    d[: n // 2] = aim - o[: n // 2]
    return o, d


def _brute_case(case, meshes):
    """(verts, o, d, ray count whose hits must be > 0) on the card.
    'tie': the teapot twice, the copy 6,400 triangles on, so any split of
    its 12,800 columns into 2 or 4 puts every copy in another split and
    every hit is a bit-equal tie across a boundary; 'nK': K rays at the
    teapot; 'miss': rays that miss everything; 'zero_dir': half the rays
    with a zero direction; 'inside': origins inside the teapot's body;
    'dragon': the 40k-triangle dragon."""
    tv, dv = meshes
    rng = np.random.default_rng(BRUTE_CASES.index(case))
    verts, n = tv, N
    if case.startswith("n"):
        n = int(case[1:])
    if case == "tie":
        verts = np.concatenate([tv, np.zeros((6400 - tv.shape[0], 3, 3), np.float32), tv])
    if case == "dragon":
        verts = dv
        lo, hi = dv.reshape(-1, 3).min(0), dv.reshape(-1, 3).max(0)
        o, d = _aimed(dv, n, rng, lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo))
    elif case == "inside":
        o = (np.array([0.0, 1.5, 0.0]) + (rng.random((n, 3)) - 0.5)).astype(np.float32)
        d = rng.standard_normal((n, 3)).astype(np.float32)
    elif case == "miss":
        o = (np.array([20.0, 20.0, 20.0]) + rng.random((n, 3))).astype(np.float32)
        d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    else:
        o, d = _aimed(tv, n, rng)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    if case == "zero_dir":
        d[1::2] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda() for x in (verts, o, d)]


@pytest.mark.parametrize("case", BRUTE_CASES)
@pytest.mark.parametrize("kernel", ["mt", "plucker"])
def test_brute_split_kernels_cases(brute_meshes, kernel, case):
    """The split kernels at the rule's split count, at 1, 2 and one split a
    tile, against the plain version, the per-ray kernel and (Möller–
    Trumbore) the torch brute force, bit for bit."""
    verts, o, d = _brute_case(case, brute_meshes)
    _, pack, plain, wrapper, per_ray = BRUTE[kernel]
    g = pack(verts)
    refs = {"plain": plain(g, o, d), "per_ray": per_ray(g, o, d)}
    if kernel == "mt":
        refs["brute_force"] = brute_force_closest(verts, o, d)
    t_ref, idx_ref = refs["plain"]
    hit = torch.isfinite(t_ref)
    for count in dict.fromkeys([None, 1, 2, g.shape[-1] // brute.TILE]):
        got = wrapper(g, o, d, splits=count)
        for name, ref in refs.items():
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (count, name)
    assert bool((idx_ref[~hit] == 0).all())
    if case == "miss":
        assert not hit.any()
    elif o.shape[0] >= 32:
        assert int(hit.sum()) > o.shape[0] // 8
    if case == "tie":
        assert bool((idx_ref[hit] < 6400).all())  # the original wins every tie
    if case == "zero_dir":
        assert not hit[1::2].any()


def _scanned(g):
    """The triangles a split kernel scans: each tile up to its last column
    with a non-zero row."""
    nz = (g.reshape(-1, g.shape[-1]) != 0).any(0).reshape(-1, brute.TILE)
    cols = torch.arange(1, brute.TILE + 1, device=g.device)
    return int(torch.where(nz, cols, 0).amax(1).sum())


@pytest.mark.parametrize("kernel", ["mt", "plucker"])
def test_brute_launch_counts_and_stats_build(brute_inputs, kernel):
    """One count per wrapper call, however many launches it makes (fill,
    split kernel, unpack), and none for 0 rays; the stats build gives the
    same bits at any split count and the same counts: every pair of a ray
    and a scanned triangle once, every warp-step once, the same stages."""
    verts, o, d = brute_inputs
    module, pack, _, wrapper, per_ray = BRUTE[kernel]
    g = pack(verts)
    before, per_before = module.launches["closest"], module.per_ray_launches["closest"]
    ref = wrapper(g, o, d, splits=1)
    wrapper(g, o, d, splits=5)
    wrapper(g, o[:0], d[:0])
    assert module.launches["closest"] == before + 2
    per_ray(g, o, d)
    assert module.per_ray_launches["closest"] == per_before + 1 and module.launches["closest"] == before + 2
    scanned = _scanned(g)
    assert scanned == verts.shape[0]
    counts = []
    for count in (1, 5):
        stats = torch.zeros((2, 4), dtype=torch.int64, device="cuda")
        got = wrapper(g, o, d, splits=count, stats=stats)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        steps, pairs = stats.tolist()
        assert sum(pairs) == N * scanned and sum(steps) == -(-N // 32) * scanned
        assert pairs[3] >= int(torch.isfinite(ref[0]).sum()) > 0
        counts.append((steps, pairs))
    assert counts[0] == counts[1]


# ---- the gradient path ----
GRAD_FRAME = dict(Width=32, Height=16, MaxPrims=96, leaf_chunk_lanes=48, recursion_depth=2)
GRAD_PARAMS = ("spheres", "lights", "triangles")


@pytest.fixture(scope="module")
def grad_scenes():
    """The teapot recipe on the card and on the CPU, and a target."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from dod_raytracer_tpu_torch.grad import render_for_grad

    cfg = T.Config(**GRAD_FRAME)
    cpu = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cpu")
    card = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cuda")
    with torch.no_grad():
        target = render_for_grad(cpu, cfg) * 0.8 + 0.02
    return cfg, cpu, card, target


def test_grads_on_the_card_match_the_cpu(grad_scenes):
    """loss_and_param_grads on the card (the packet walk, sorted bounces,
    batched shadows) vs the CPU (the plain walk), by chip_smoke.py phase
    18's rule: the loss to rtol 1e-3; per leaf, the relative L1 distance
    under 1e-2, and in leaves of 1,000 or more elements at most 0.1% of
    elements off by more than rtol 1e-3 (atol 1e-6 of the leaf's largest
    grad).  The card's torch ops round otherwise than the CPU's (a
    grazing hit's grads magnify that), a borderline hit can flip over the
    bounces, and the gathers' backward accumulates with atomics."""
    from dod_raytracer_tpu_torch.grad import leaves, loss_and_param_grads

    cfg, cpu, card, target = grad_scenes
    loss_c, grads_c = loss_and_param_grads(cpu, target, cfg, GRAD_PARAMS)
    loss_g, grads_g = loss_and_param_grads(card, target.cuda(), cfg, GRAD_PARAMS)
    np.testing.assert_allclose(float(loss_g), float(loss_c), rtol=1e-3)
    for g_c, g in zip(leaves(grads_c), leaves(grads_g)):
        g = g.cpu()
        assert bool(torch.isfinite(g).all())
        close = torch.isclose(g, g_c, rtol=1e-3, atol=1e-6 * float(g_c.abs().max()))
        assert g.numel() < 1000 or float((~close).float().mean()) <= 1e-3
        assert float((g - g_c).abs().sum() / g_c.abs().sum().clamp_min(1e-30)) < 1e-2


@pytest.mark.parametrize("path", ["packet", "packet_remat", "mt", "plucker"])
def test_backward_launches_no_kernel(grad_scenes, path):
    """The forward of a gradient frame launches its kernels; the backward
    launches no traversal kernel (remat_bounces reads the traversal
    outputs back).  Under remat_bounces the backward's recompute of a
    bounce launches the families' closest-hit kernel once, as its forward
    did, and nothing else."""
    from dod_raytracer_tpu_torch.grad import merge_params, mse_loss

    cfg, _, card, target = grad_scenes
    cfg = dataclasses.replace(cfg, **{
        "packet": {}, "packet_remat": {"remat_bounces": True},
        "mt": {"brute_threshold": card.n_triangles, "triangle_backend": "pallas"},
        "plucker": {"brute_threshold": card.n_triangles, "triangle_backend": "plucker"}}[path])
    counts = {"packet": (packet.launches, ("closest", "any_hit")), "mt": (mt.launches, ("closest",)),
              "plucker": (plucker.launches, ("closest",))}[path.split("_")[0]]
    verts = card.triangles.verts.detach().clone().requires_grad_(True)
    before = {m: counts[0][m] for m in counts[1]}
    before_closest = families.launches["closest"]
    loss = mse_loss(merge_params(card, {"triangles.verts": verts}), target.cuda(), cfg)
    fwd = {m: counts[0][m] - before[m] for m in counts[1]}
    assert all(n > 0 for n in fwd.values()), fwd
    closest = families.launches["closest"]
    after = dict(packet.launches), dict(mt.launches), dict(plucker.launches), dict(families.launches)
    if path == "packet_remat":
        after[3]["closest"] += closest - before_closest
    loss.backward()
    assert (dict(packet.launches), dict(mt.launches), dict(plucker.launches), dict(families.launches)) == after
    assert bool(torch.isfinite(verts.grad).all()) and float(verts.grad.abs().max()) > 0


# ---- the families' any-hit kernel (csrc/families_any.cu): its plain version's bits, no lane excused ----

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_families_kernel(scene, o, d, t_max, eps):
    """One launch on the card, equal bit for bit to the plain version on
    the card -> the bits."""
    before = families.launches["any"]
    got = families.occluded_any(scene, o, d, t_max, eps)
    assert families.launches["any"] == before + 1
    assert got.dtype == torch.bool and got.device == o.device
    assert torch.equal(got, families.occluded_plain(scene, o, d, t_max, eps))
    return got


@pytest.fixture(scope="module")
def teapot_ref_frame():
    """The benchmark's teapot-ref frame (config.ini, 1920x1080, the teapot,
    MaxPrims=96, leaf_chunk_lanes=48, two tiles of 1,036,800 rays) on the
    card, every call of the families' any-hit checked against the plain
    version on its own inputs -> ([(lanes, lanes that differ, blocked)]
    per call, launches of the frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = T.Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=1036800)
    scene = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cuda")
    door, calls = families.occluded_any, []

    def checking(scene, o, d, t_max, eps):
        got = door(scene, o, d, t_max, eps)
        ref = families.occluded_plain(scene, o, d, t_max, eps)
        calls.append((o.shape[0], int((got != ref).sum()), int(ref.sum())))
        return got

    mp = pytest.MonkeyPatch()
    mp.setattr(families, "occluded_any", checking)
    families.reset_launches()
    try:
        T.render_image(scene, cfg, device="cuda")
    finally:
        mp.undo()
    return calls, families.launches["any"]


@pytest.mark.parametrize("bounce", [0, 3])
def test_families_kernel_on_the_teapot_ref_frame(teapot_ref_frame, bounce):
    """Every lane of the frame's shadow wavefronts at ``bounce``, in both
    tiles (call k and 10 + k), is the plain version's bit; one launch a
    bounce and tile: 20 a frame."""
    calls, launched = teapot_ref_frame
    assert launched == len(calls) == 20
    for lanes, differ, blocked in (calls[bounce], calls[10 + bounce]):
        assert lanes == 9 * 1036800 and differ == 0 and 0 < blocked < lanes


def test_families_kernel_hard_rays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = R.hard_scene(T, device="cuda")
    o, d, t_max, expected = R.hard_rays()
    got = assert_families_kernel(scene, *(torch.from_numpy(x).cuda() for x in (o, d, t_max)), R.EPS)
    np.testing.assert_array_equal(got.cpu().numpy(), expected)


@pytest.mark.parametrize("case", ["random", "at_hit"])
@pytest.mark.parametrize("scene_name", ["hard", "many", "bare"])
def test_families_kernel_random_rays(scene_name, case):
    """Random rays (killed, clipped and unclipped lanes), and rays clipped
    exactly at their first family hit and one ulp past it; ``bare`` has
    only the builder's padding (a radius-0 sphere, a zero-normal plane, a
    cylinder column past n_cylinders = 0) and blocks nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = {"hard": lambda: R.hard_scene(T, device="cuda"), "many": lambda: R.many_scene(T, "cuda"),
             "bare": lambda: T.SceneBuilder().build(T.Config(use_kdtree=False), device="cuda")}[scene_name]()
    o, d, t_max = (torch.from_numpy(x).cuda() for x in R.random_rays(seed=9, n=65536, spread=9.0))
    if case == "at_hit":
        t_first = R.first_hit_t(scene, o, d, R.EPS)
        t_max = torch.from_numpy(R.at_hit(t_first.cpu().numpy())).cuda()
    got = assert_families_kernel(scene, o, d, t_max, R.EPS)
    if scene_name == "bare":
        assert not bool(got.any())
    else:
        assert 0 < int(got.sum()) < o.shape[0]


def test_families_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = R.hard_scene(T, device="cuda")
    o, d, t_max = (torch.from_numpy(x).cuda() for x in R.random_rays(seed=10, n=256))
    before = families.launches["any"]
    with pytest.raises(TypeError):
        families.occluded_any(scene, o, d, t_max.double(), R.EPS)
    with pytest.raises(ValueError):
        families.occluded_any(scene, o[:, :2], d, t_max, R.EPS)
    with pytest.raises(ValueError):
        families.occluded_any(R.hard_scene(T, device="cpu"), o, d, t_max, R.EPS)
    assert families.launches["any"] == before
    # non-contiguous rays are made contiguous, not refused
    wide = torch.cat([o, d], dim=1)
    assert torch.equal(families.occluded_any(scene, wide[:, :3], wide[:, 3:], t_max, R.EPS),
                       families.occluded_plain(scene, o, d, t_max, R.EPS))


# ---- the families' closest-hit kernel (csrc/families_closest.cu): its plain version's bits ----

def assert_closest_kernel(scene, o, d, t_max, eps, color_bug=False):
    """One launch on the card, equal to the plain version on the card: the
    winner and t bit for bit on every ray, the normal and colour on every
    ray that hits, zeros in both on a miss -> (winner, hit)."""
    before = families.launches["closest"]
    winner, got = families.closest_kernel(scene, o, d, t_max, eps, color_bug)
    assert families.launches["closest"] == before + 1
    ref_winner, ref = families.closest_plain(scene, o, d, t_max, eps, color_bug)
    assert torch.equal(winner, ref_winner) and torch.equal(got.t, ref.t)
    hit = winner >= 0
    assert torch.equal(hit, torch.isfinite(ref.t))
    assert torch.equal(got.normal[hit], ref.normal[hit]) and torch.equal(got.color[hit], ref.color[hit])
    assert not bool(got.normal[~hit].any()) and not bool(got.color[~hit].any())
    return winner, got


@pytest.mark.parametrize("color_bug", [False, True])
def test_closest_kernel_tie_and_hard_rays(color_bug):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    o, d, t_max, code, t = R.tie_rays()
    winner, got = assert_closest_kernel(R.tie_scene(T, device="cuda"),
                                        *(torch.from_numpy(x).cuda() for x in (o, d, t_max)), R.EPS, color_bug)
    np.testing.assert_array_equal(winner.cpu().numpy(), code)
    np.testing.assert_array_equal(got.t.cpu().numpy(), t)
    o, d, t_max, _ = R.hard_rays()
    assert_closest_kernel(R.hard_scene(T, device="cuda"), *(torch.from_numpy(x).cuda() for x in (o, d, t_max)),
                          R.EPS, color_bug)


@pytest.mark.parametrize("case", ["random", "at_hit"])
@pytest.mark.parametrize("scene_name", ["hard", "tie", "many", "bare"])
def test_closest_kernel_random_rays(scene_name, case):
    """Random rays (killed, clipped and unclipped), and rays clipped exactly
    at their first family hit and one ulp past it; ``many`` stages more
    than one chunk of each family; ``bare`` (SceneBuilder's padding alone)
    hits nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = {"hard": lambda: R.hard_scene(T, device="cuda"), "tie": lambda: R.tie_scene(T, device="cuda"),
             "many": lambda: R.many_scene(T, "cuda"),
             "bare": lambda: T.SceneBuilder().build(T.Config(use_kdtree=False), device="cuda")}[scene_name]()
    o, d, t_max = (torch.from_numpy(x).cuda() for x in R.random_rays(seed=19, n=65536, spread=9.0))
    if case == "at_hit":
        t_max = torch.from_numpy(R.at_hit(R.first_hit_t(scene, o, d, R.EPS).cpu().numpy())).cuda()
    winner, _ = assert_closest_kernel(scene, o, d, t_max, R.EPS)
    hits = int((winner >= 0).sum())
    assert hits == 0 if scene_name == "bare" else 0 < hits < o.shape[0]


def test_closest_paths_give_the_kernel_bits():
    """With gradients on, the colour path (the kernel's t and normal, the
    colour gathered by the winner) and the geometry path (the winner's hit
    recomputed in torch on the card) give the kernel's bits on every ray
    that hits, each after one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = T.Config(use_kdtree=False)
    scene = T.default_scene(seed=3, cfg=cfg, mesh=None).build(cfg, device="cuda")
    o, d, t_max = (torch.from_numpy(x).cuda() for x in R.random_rays(seed=20, n=65536, spread=4.0))
    winner, ref = assert_closest_kernel(scene, o, d, t_max, R.EPS)
    hit = winner >= 0
    colours = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, color=scene.spheres.color.clone().requires_grad_(True)))
    for sc, oo in ((colours, o), (scene, o.clone().requires_grad_(True))):
        before = families.launches["closest"]
        got = families.closest(sc, oo, d, t_max, R.EPS, False)
        assert families.launches["closest"] == before + 1
        assert torch.equal(got.t, ref.t)
        assert torch.equal(got.normal[hit], ref.normal[hit]) and torch.equal(got.color[hit], ref.color[hit])
        assert got.t.requires_grad == got.normal.requires_grad == oo.requires_grad
        assert got.color.requires_grad == sc.spheres.color.requires_grad


@pytest.fixture(scope="module")
def teapot_closest_frame():
    """The benchmark's teapot-ref frame on the card (two tiles of 1,036,800
    rays), every call of the families' closest hit checked against the
    plain version on its inputs, and the frame again with the plain
    version in the kernel's place -> ([(rays, rays that differ, hits)] per
    call, launches, the frame, the plain version's frame)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cfg = T.Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=1036800)
    scene = T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cuda")
    calls = []

    def checking(scene, o, d, t_max, eps, color_bug):
        winner, got = families.closest_kernel(scene, o, d, t_max, eps, color_bug)
        ref_winner, ref = families.closest_plain(scene, o, d, t_max, eps, color_bug)
        hit = ref_winner >= 0
        differ = (winner != ref_winner) | (got.t != ref.t) | hit & ((got.normal != ref.normal).any(1)
                                                                    | (got.color != ref.color).any(1))
        calls.append((o.shape[0], int(differ.sum()), int(hit.sum())))
        return got

    def plain(scene, o, d, t_max, eps, color_bug):
        return families.closest_plain(scene, o, d, t_max, eps, color_bug)[1]

    mp = pytest.MonkeyPatch()
    families.reset_launches()
    try:
        mp.setattr(families, "closest", checking)
        T.render_image(scene, cfg, device="cuda")
        launched = families.launches["closest"]
        mp.undo()
        img = T.render_image(scene, cfg, device="cuda")
        mp.setattr(families, "closest", plain)
        img_plain = T.render_image(scene, cfg, device="cuda")
    finally:
        mp.undo()
    return calls, launched, img, img_plain


@pytest.mark.parametrize("bounce", [0, 3, 9])
def test_closest_kernel_on_the_teapot_ref_frame(teapot_closest_frame, bounce):
    """Every ray of the frame's closest-hit wavefronts at ``bounce``, in both
    tiles (call k and 10 + k), is the plain version's; one launch a
    bounce and tile: 20 a frame."""
    calls, launched, _, _ = teapot_closest_frame
    assert launched == len(calls) == 20
    for rays, differ, hits in (calls[bounce], calls[10 + bounce]):
        assert rays == 1036800 and differ == 0 and 0 < hits


def test_teapot_ref_frame_equals_the_plain_versions_frame(teapot_closest_frame):
    """The 10-bounce frame with the kernel (zeros on its misses) is the
    frame with the plain version (garbage there) bit for bit: nothing
    reads a miss's normal or colour."""
    _, _, img, img_plain = teapot_closest_frame
    assert torch.equal(img, img_plain)


def test_closest_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = R.hard_scene(T, device="cuda")
    o, d, t_max = (torch.from_numpy(x).cuda() for x in R.random_rays(seed=21, n=256))
    before = families.launches["closest"]
    with pytest.raises(TypeError):
        families.closest(scene, o, d, t_max.double(), R.EPS, False)
    with pytest.raises(ValueError):
        families.closest(scene, o[:, :2], d, t_max, R.EPS, False)
    with pytest.raises(ValueError):
        families.closest(R.hard_scene(T, device="cpu"), o, d, t_max, R.EPS, False)
    assert families.launches["closest"] == before
    # non-contiguous rays are made contiguous, not refused
    wide = torch.cat([o, d], dim=1)
    with torch.no_grad():
        got = families.closest(scene, wide[:, :3], wide[:, 3:], t_max, R.EPS, False)
    assert torch.equal(got.t, families.closest_plain(scene, o, d, t_max, R.EPS, False)[1].t)
