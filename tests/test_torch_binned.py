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
same order through the same leaf test.  The CUDA kernel's own tests are in
``tests/test_torch_cuda.py``.
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
