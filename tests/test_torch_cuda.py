"""The CUDA kd-traversal kernel vs the plain walk, on a CUDA device.

The kernel has no CPU mode, so every test here skips without a card.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:  python -m pytest --noconftest tests/test_torch_cuda.py

Parity rules of the packet traversal (tests/test_packet.py): hit masks
agree, t agrees to rtol 1e-3 where both hit, and a prim may differ only
where both candidates' Möller–Trumbore t agree to rtol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.ops import packet
from dod_raytracer_tpu_torch.ops import traverse as ttrav

N = 4096


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


def mt_t(verts, prim, o, d):
    tri = verts[prim]
    a, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = np.cross(d, e2)
    det = np.sum(e1 * p, axis=1)
    q = np.cross(o - a, e1)
    return np.sum(e2 * q, axis=1) / det


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_closest_matches_plain_walk(teapot_kd, case):
    tv, kd, depth = teapot_kd
    o, d, t_max = make_rays(case, seed=4)
    before = packet.launches["closest"]
    tk, pk, fk = packet.packet_traverse(kd, o, d, t_max, depth, False)
    assert packet.launches["closest"] == before + 1
    tp, pp, fp = ttrav.traverse_plain(kd, o, d, t_max, depth, False)
    hk = (fk & (tk < t_max)).cpu().numpy()
    hp = (fp & (tp < t_max)).cpu().numpy()
    assert hp.sum() > N // 8
    np.testing.assert_array_equal(hk, hp)
    tk, tp, pk, pp = (x.cpu().numpy() for x in (tk, tp, pk, pp))
    np.testing.assert_allclose(tk[hp], tp[hp], rtol=1e-3)
    flip = hp & (pk != pp)
    if flip.any():
        on, dn = o.cpu().numpy()[flip], d.cpu().numpy()[flip]
        np.testing.assert_allclose(mt_t(tv, pk[flip], on, dn), mt_t(tv, pp[flip], on, dn), rtol=1e-5)


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_any_hit_matches_plain_walk(teapot_kd, case):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays(case, seed=5)
    before = packet.launches["any_hit"]
    _, _, fk = packet.packet_traverse(kd, o, d, t_max, depth, True)
    assert packet.launches["any_hit"] == before + 1
    _, _, fp = ttrav.traverse_plain(kd, o, d, t_max, depth, True)
    np.testing.assert_array_equal(fk.cpu().numpy(), fp.cpu().numpy())


def test_wrapper_rejects_bad_inputs(teapot_kd):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    with pytest.raises(TypeError):
        packet.packet_traverse(kd, o.double(), d, t_max, depth, False)
    with pytest.raises(ValueError):
        packet.packet_traverse(kd, o[:, :2].contiguous(), d, t_max, depth, False)
    with pytest.raises(ValueError):
        packet.packet_traverse(kd, o, d, t_max, 65, False)


def test_wrapper_rejects_missing_kd_tables(teapot_kd):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("unclipped", seed=6)
    before = dict(packet.launches)
    for name in ("block_g", "block_aabb", "block_tris"):
        with pytest.raises(ValueError, match=name):
            packet.packet_traverse(dataclasses.replace(kd, **{name: None}), o, d, t_max, depth, False)
    assert packet.launches == before


@pytest.mark.parametrize("any_hit", [False, True])
def test_stats_build_gives_the_same_result(teapot_kd, any_hit):
    _, kd, depth = teapot_kd
    o, d, t_max = make_rays("clipped", seed=7)
    ref = packet.packet_traverse(kd, o, d, t_max, depth, any_hit)
    stats = torch.zeros((N, 3), dtype=torch.int32, device="cuda")
    got = packet.packet_traverse(kd, o, d, t_max, depth, any_hit, stats=stats)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    steps, blocks, slots = stats.long().sum(0).tolist()
    valid_per_block = int((kd.block_orig >= 0).sum(1).max())
    assert steps > 0 and blocks > 0 and 0 < slots <= blocks * valid_per_block
