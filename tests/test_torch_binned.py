"""The binned kd walk: the port's block-loop leaf stage and binned walk
(``ops/binned.py``; the CUDA kernel's plain version, taken for CPU
tensors) vs the JAX package's Pallas ``block_loop_intersect`` and its
``"binned"`` traversal run in interpret mode, as
``tests/test_kdtree.py::TestBinnedTraversal`` runs them; and the binned
walk vs the port's plain walk.

Parity rule against JAX (tests/test_kdtree.py:140-144): hit masks and
prims equal, t to rtol 1e-3 where both hit, because the JAX kernel takes t
from the Plücker num/den and the port from Möller–Trumbore.  Against the
port's plain walk the binned walk is bit for bit: the same blocks in the
same order through the same leaf test.  The walk's rounds as the card runs
them (``binned.walk_rounds``: the round kernel's plain version
``descend_plain``, then the leaf stage over every ray of the batch) are
held to both.  The CUDA kernels' own tests are in
``tests/test_torch_cuda.py``.

Torch runs on one intra-op thread here: the rounds are many small ops,
which slow badly when the test workers contend for the cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.ops.pallas.block_loop_kernel import block_loop_intersect as j_block_loop
from dod_raytracer_tpu.ops.pallas.plucker_kernel import swizzle_rays_plucker
from dod_raytracer_tpu_torch.ops import binned
from dod_raytracer_tpu_torch.ops import traverse as ttrav
from test_torch_walks import N, _jax, _port, make_rays, pair  # noqa: F401  (module-scoped fixture)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block_rays(kd, tv, seed):
    """tests/test_kdtree.py ``random_rays`` origins, half the rays aimed at
    a random triangle, each with the key of a block that holds that
    triangle; the other half with random keys, an eighth of them >= B."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((N, 3), dtype=np.float32) * 2 - 1) * 6.0).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    orig = kd.block_orig.numpy()
    B = orig.shape[0]
    keys = rng.integers(0, B, N).astype(np.int32)
    keys[N // 2:N // 2 + N // 8] = B + rng.integers(0, 3, N // 8)
    for i in range(N // 2):
        blk = rng.integers(0, B)
        tri = orig[blk][orig[blk] >= 0]
        if tri.size:
            keys[i] = blk
            d[i] = tv[rng.choice(tri)].mean(axis=0) - o[i]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32), keys


def test_block_loop_matches_jax_kernel(pair):
    _, tv, jscene, tkd, _ = pair
    o, d, keys = _block_rays(tkd, tv, seed=3)
    rows, _ = swizzle_rays_plucker(jnp.asarray(o), jnp.asarray(d), 256)
    jkd = jscene.kd
    t_ref, p_ref = (np.asarray(x)[:N] for x in j_block_loop(
        rows, jnp.asarray(np.pad(keys, (0, (-N) % 256), constant_values=2**30))[:, None],
        jkd.block_g, jkd.block_orig, interpret=True))
    t, p = binned.block_loop_intersect(tkd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(keys))
    t, p = t.numpy(), p.numpy()
    hit = np.isfinite(t_ref)
    assert hit.sum() > N // 8
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-3)
    np.testing.assert_array_equal(p[hit], p_ref[hit])
    np.testing.assert_array_equal(p[~hit], 2**30)  # keys >= B and blocks without a hit, as JAX
    assert (keys >= tkd.block_orig.shape[0]).any()


@pytest.mark.parametrize("case", ["unclipped", "clipped", "inside"])
def test_binned_walk_matches_jax(pair, case):
    name, tv, jscene, tkd, kw = pair
    o, d, t_max = make_rays(tv, case, seed=3)
    ref = _jax(jscene, o, d, t_max, "binned", False, kw)
    got = _port(tkd, o, d, t_max, "binned", False, kw)
    hit = ref[2]
    assert hit.sum() > N // 8
    np.testing.assert_array_equal(got[2], hit)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-3)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    ref_any = _jax(jscene, o, d, np.minimum(t_max, 5.0).astype(np.float32), "binned", True, kw)
    assert 0 < ref_any.sum() < N
    np.testing.assert_array_equal(
        _port(tkd, o, d, np.minimum(t_max, 5.0).astype(np.float32), "binned", True, kw), ref_any)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_walk_gives_the_plain_walks_bits(pair, any_hit):
    _, tv, _, tkd, kw = pair
    o, d, t_max = (torch.from_numpy(x) for x in make_rays(tv, "clipped", seed=7))
    depth = ttrav._stack_depth(tkd, T.Config(**kw))
    before = dict(binned.launches)
    ref = ttrav.traverse_plain(tkd, o, d, t_max, depth, any_hit)
    got = binned.binned_traverse(tkd, o, d, t_max, depth, any_hit)
    assert bool(ref[2].any())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert binned.launches == before  # CPU tensors launch nothing


def test_block_loop_keys_outside_the_tree_give_no_hit(pair):
    _, tv, _, tkd, _ = pair
    o, d, keys = _block_rays(tkd, tv, seed=5)
    B = tkd.block_orig.shape[0]
    ref = binned.block_loop_intersect(tkd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(keys))
    bad = np.zeros(N, bool)
    bad[::3] = True
    keys[bad] = np.resize(np.array([-1, -(2**31), B, B + 7, 2**31 - 1], np.int64), int(bad.sum()))
    t, p = binned.block_loop_intersect(tkd, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(keys))
    assert not torch.isfinite(t[bad]).any()
    assert bool((p[bad] == 2**30).all())
    assert torch.equal(t[~bad], ref[0][~bad]) and torch.equal(p[~bad], ref[1][~bad])  # the others keep theirs
    assert bool(torch.isfinite(t[~bad]).any())


def _idle_batch(tv, seed):
    """make_rays's clipped rays, with rays that are idle from the first
    round: the first 8 dead (t_max = -1), N / 8 that miss the tree's box,
    8 with t_max = 0."""
    o, d, t_max = make_rays(tv, "clipped", seed)
    miss = slice(N // 4, N // 4 + N // 8)
    o[miss] = 40.0
    d[miss] = np.float32(1.0 / np.sqrt(3.0))
    t_max[N // 2 - 8:N // 2] = 0.0
    idle = np.zeros(N, bool)
    idle[:8] = idle[miss] = idle[N // 2 - 8:N // 2] = True
    return o, d, t_max, idle


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_rounds_match_the_plain_walk_and_jax(pair, any_hit):
    """The walk as the card runs it, in rounds over the whole batch with
    idle rays among it (key -1 in every round), gives traverse_plain's
    bits and the JAX "binned" walk's hits; the last round has no key."""
    name, tv, jscene, tkd, kw = pair
    o, d, t_max, idle = _idle_batch(tv, seed=9)
    if any_hit:
        t_max = np.where(t_max > 0, np.minimum(t_max, 5.0), t_max).astype(np.float32)
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, t_max))
    depth = ttrav._stack_depth(tkd, T.Config(**kw))
    rounds = []

    def leaf(kd, o_, d_, keys):
        assert o_.shape[0] == N
        rounds.append(keys.clone())
        return ttrav.leaf_plain(kd, o_, d_, keys)

    got = binned.walk_rounds(tkd, ot, dt, tt, depth, any_hit, leaf)
    ref = ttrav.traverse_plain(tkd, ot, dt, tt, depth, any_hit)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert len(rounds) > 2
    assert all(bool((k[torch.from_numpy(idle)] == -1).all()) for k in rounds)
    assert bool((rounds[-1] == -1).all()) and bool((rounds[0] >= 0).any())
    ref_j = _jax(jscene, o, d, t_max, "binned", any_hit, kw)
    if any_hit:
        assert 0 < ref_j.sum() < N
        np.testing.assert_array_equal(got[2].numpy(), ref_j)
        return
    hit = ref_j[2]
    assert hit.sum() > N // 8
    np.testing.assert_array_equal((got[2] & (got[0] < tt)).numpy(), hit)
    np.testing.assert_allclose(got[0].numpy()[hit], ref_j[0][hit], rtol=1e-3)
    np.testing.assert_array_equal(got[1].numpy()[hit], ref_j[1][hit])
