"""The brute-force intersectors: the port's Möller–Trumbore and Plücker
kernels' plain versions (``ops/mt.py``, ``ops/plucker.py``, taken for CPU
tensors) vs the JAX package's Pallas ``mt_closest_pallas`` and
``plucker_closest`` run in interpret mode, as ``tests/test_pallas.py``
runs them; their input layouts vs the JAX package's run op by op; the
brute-force frames of ``triangle_backend="pallas"`` / ``"plucker"``; and
the kernels' triangle-axis split (``ops/brute.py``): the rule that picks
the split count, and the plain versions run split by split and merged by
the kernels' 64-bit (t, index) key rule, bit for bit against one
unsplit run.

Tolerances are ``tests/test_pallas.py``'s: hit masks and indices equal, t
to rtol 1e-5 for Möller–Trumbore (the JAX kernel is one fused XLA program,
the port one rounding per operation) and 1e-4 for Plücker.  The CUDA
kernels' own tests are in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.ops.pallas import mt_kernel as jmt
from dod_raytracer_tpu.ops.pallas import plucker_kernel as jpl
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.ops import brute, mt, plucker
from dod_raytracer_tpu_torch.ops.triangle import brute_force_closest


def rays(n, seed=0):
    """tests/test_pallas.py ``rays``."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * 6).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _double_sided():
    """tests/test_pallas.py ``test_double_sided_and_degenerate``: one
    triangle met from both sides, and a degenerate one."""
    tri = np.asarray([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]], [[0, 0, 0], [0, 0, 0], [0, 0, 0]]], np.float32)
    o = np.asarray([[0, 0, 0], [0, 0, 4]], np.float32)
    d = np.asarray([[0, 0, 1], [0, 0, -1]], np.float32)
    return tri, o, d


CASES = {
    "teapot": lambda: (load_mesh_asset("teapot")[0], *rays(512)),
    "unaligned37": lambda: ((np.random.default_rng(1).standard_normal((37, 3, 3)) * 2).astype(np.float32),
                            *rays(100, seed=2)),
    "double_sided": _double_sided,
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return request.param, *CASES[request.param]()


def _assert_same_hits(got, ref, rtol):
    (tg, ig), (tr, ir) = ([np.asarray(x) for x in p] for p in (got, ref))
    hit = np.isfinite(tr)
    np.testing.assert_array_equal(np.isfinite(tg), hit)
    np.testing.assert_allclose(tg[hit], tr[hit], rtol=rtol)
    np.testing.assert_array_equal(ig[hit], ir[hit])
    return hit


def test_mt_matches_jax_kernel(case):
    name, tv, o, d = case
    ref = jmt.mt_closest_pallas(jmt.swizzle_tris(jnp.asarray(tv)), jnp.asarray(o), jnp.asarray(d),
                                interpret=True)
    got = mt.mt_closest(mt.swizzle_tris(torch.from_numpy(tv)), torch.from_numpy(o), torch.from_numpy(d))
    hit = _assert_same_hits(got, ref, 1e-5)
    assert hit.any()
    # the kernel's plain version is the torch brute force, bit for bit
    bf = brute_force_closest(torch.from_numpy(tv), torch.from_numpy(o), torch.from_numpy(d))
    for a, b in zip(got, bf):
        assert torch.equal(a, b)
    if name == "double_sided":
        np.testing.assert_array_equal(got[1].numpy(), [0, 0])


def test_plucker_matches_jax_kernel(case):
    name, tv, o, d = case
    ref = jpl.plucker_closest(jpl.plucker_pack(jnp.asarray(tv)), jnp.asarray(o), jnp.asarray(d),
                              interpret=True)
    got = plucker.plucker_closest(plucker.plucker_pack(torch.from_numpy(tv)), torch.from_numpy(o),
                                  torch.from_numpy(d))
    hit = _assert_same_hits(got, ref, 1e-4)
    assert hit.any()
    # and against Möller–Trumbore brute force with tests/test_pallas.py's rule
    _assert_same_hits(got, brute_force_closest(torch.from_numpy(tv), torch.from_numpy(o), torch.from_numpy(d)),
                      1e-4)
    if name == "double_sided":
        np.testing.assert_allclose(got[0].numpy(), [2.0, 2.0], atol=1e-6)
        np.testing.assert_array_equal(got[1].numpy(), [0, 0])


def test_layouts_equal_jax_op_by_op(case):
    """swizzle_tris, swizzle_rays, plucker_pack and swizzle_rays_plucker,
    bit for bit, at the kernels' tiles and at a ray tile that pads."""
    _, tv, o, d = case
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o), torch.from_numpy(d)
    with jax.disable_jit():
        pairs = [(mt.swizzle_tris(torch.from_numpy(tv)), jmt.swizzle_tris(jnp.asarray(tv))),
                 (plucker.plucker_pack(torch.from_numpy(tv)), jpl.plucker_pack(jnp.asarray(tv)))]
        for tile_r in (1, 256):
            pairs += [(mt.swizzle_rays(to, td, tile_r), jmt.swizzle_rays(jo, jd, tile_r)),
                      (plucker.swizzle_rays_plucker(to, td, tile_r), jpl.swizzle_rays_plucker(jo, jd, tile_r))]
        for got, ref in pairs:
            if isinstance(got, tuple):
                assert got[1] == ref[1]
                got, ref = got[0], ref[0]
            assert tuple(got.shape) == ref.shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_on_cpu_count_no_launch(case):
    _, tv, o, d = case
    before = dict(mt.launches), dict(plucker.launches)
    mt.mt_closest(mt.swizzle_tris(torch.from_numpy(tv)), torch.from_numpy(o), torch.from_numpy(d))
    plucker.plucker_closest(plucker.plucker_pack(torch.from_numpy(tv)), torch.from_numpy(o), torch.from_numpy(d))
    assert (dict(mt.launches), dict(plucker.launches)) == before


def _frame_recipe(pkg, backend):
    """tests/test_pallas.py ``test_pallas_backend_render_matches_jnp``:
    64 random triangles, no kd tree, 24x16, 2 bounces."""
    rng = np.random.default_rng(3)
    tv = (rng.standard_normal((64, 3, 3)) * 1.5).astype(np.float32)
    tn = np.tile(np.eye(3)[None], (64, 1, 1)).astype(np.float32)
    cfg = pkg.Config(Width=24, Height=16, use_kdtree=False, ray_tile=512, recursion_depth=2,
                     triangle_backend=backend)
    b = pkg.SceneBuilder()
    b.add_mesh(tv, tn, color=(0.6, 0.5, 0.4))
    b.add_light((0.0, 2.0, -3.0), 4.0)
    return b, cfg


@pytest.fixture(scope="module")
def port_frames():
    frames = {}
    for backend in ("jnp", "pallas", "plucker"):
        b, cfg = _frame_recipe(T, backend)
        frames[backend] = T.render_image(b.build(cfg, device="cpu"), cfg, device="cpu").numpy()
    return frames


@pytest.mark.parametrize("backend", ["pallas", "plucker"])
def test_brute_frame_matches_jax(port_frames, backend):
    b, cfg = _frame_recipe(J, backend)
    ref = np.asarray(J.render_image(b.build(cfg), cfg))
    np.testing.assert_allclose(port_frames[backend], ref, atol=1e-5)


def test_pallas_frame_equals_jnp_frame(port_frames):
    assert port_frames["jnp"].mean() > 0.01
    np.testing.assert_array_equal(port_frames["pallas"], port_frames["jnp"])


# ---- the triangle-axis split of the CUDA kernels (ops/brute.py) ----

@pytest.mark.parametrize("n, t_total", [(1, 512), (5, 6656), (255, 6656), (257, 6656), (16384, 6656),
                                        (65536, 870400), (2073600, 6656), (2**31 - 1, 512)])
def test_split_rule(n, t_total):
    """Splits >= 1 and at most one a tile; the 480x270 frame's 16,384-ray
    launch over the teapot's 6,656 columns splits, a 2,073,600-ray launch
    does not; the ranges cover [0, T') in order, each at least one tile."""
    count = brute.splits(n, t_total)
    assert 1 <= count <= t_total // brute.TILE
    if (n, t_total) == (16384, 6656):
        assert count > 1
    if n >= 2073600:
        assert count == 1
    r = brute.ranges(t_total, count)
    assert len(r) == count and r[0][0] == 0 and r[-1][1] == t_total
    assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
    assert all(stop - start >= brute.TILE and start % brute.TILE == 0 for start, stop in r)


def _tie_case():
    """The teapot twice, the copy 6,400 triangles on (zero triangles fill
    the gap): with 2 or 4 splits of the padded 12,800 every copy lies in
    another split than its original, so every hit is a bit-equal tie
    across a split boundary.  1,024 rays: 768 aimed at triangles, 128 in
    random directions, 64 that miss everything, 64 with a zero direction."""
    tv, _ = load_mesh_asset("teapot")
    verts = np.concatenate([tv, np.zeros((6400 - tv.shape[0], 3, 3), np.float32), tv])
    rng = np.random.default_rng(7)
    o = ((rng.random((1024, 3)) * 2 - 1) * 6.0).astype(np.float32)
    d = rng.standard_normal((1024, 3)).astype(np.float32)
    d[:768] = tv[rng.integers(0, tv.shape[0], 768)].mean(axis=1) - o[:768]
    o[896:960] = (20.0, 20.0, 20.0)  # above and beside the mesh, pointing away
    d[896:960] = (0.0, 1.0, 0.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[960:] = 0.0
    return tv.shape[0], *(torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in (verts, o, d))


@pytest.fixture(scope="module")
def tie_case():
    n_tri, verts, o, d = _tie_case()
    out = {}
    for name, pack, plain in (("mt", mt.swizzle_tris, mt.mt_closest_plain),
                              ("plucker", plucker.plucker_pack, plucker.plucker_closest_plain)):
        packed = pack(verts)
        out[name] = (packed, plain, plain(packed, o, d))
    return n_tri, o, d, out


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("kernel", ["mt", "plucker"])
def test_split_merge_equals_one_scan(tie_case, kernel, count):
    """Each kernel's plain version over each split's triangles, its indices
    offset by the split's start, merged by the kernels' key rule
    (``brute.merge_plain``), gives the unsplit run's bits: the original
    wins every tie against its copy in a later split."""
    n_tri, o, d, out = tie_case
    packed, plain, whole = out[kernel]
    assert packed.shape[-1] == 12800
    parts = []
    for start, stop in brute.ranges(packed.shape[-1], count):
        t, idx = plain(packed[..., start:stop].contiguous(), o, d)
        parts.append((t, idx + start))
    got = brute.merge_plain(parts, o.shape[0])
    for a, b in zip(got, whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    hit = torch.isfinite(whole[0])
    assert int(hit[:768].sum()) > 384 and not hit[896:].any()
    assert bool((whole[1][hit] < n_tri).all()) and bool((whole[1][~hit] == 0).all())
    # the copies alone give the same t: every hit was a tie across a boundary
    t_copy, _ = plain(packed[..., 6400:].contiguous(), o, d)
    assert torch.equal(t_copy, whole[0])
