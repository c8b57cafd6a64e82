"""The port's leaf-sharded build (``dod_raytracer_tpu_torch.parallel.leaf_shard``)
against the JAX package's (``dod_raytracer_tpu.parallel.leaf_shard``), on
``tests/test_leaf_shard.py``'s scene, in one process: each shard's
tables, and its blocks refreshed after a vertex update, equal the
unpadded part of JAX's stacked slice bit for bit; a rank's scene from
JAX's stacked one (``local_scene_from_numpy``) agrees with the port's
build; a sharded scene needs its axis.  The leaf-sharded frames and the
2D step run in gloo worlds of processes: ``tests/test_torch_parallel.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dod_raytracer_tpu as J
import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.parallel import leaf_shard as jls
from dod_raytracer_tpu_torch.mesh import load_mesh_asset
from dod_raytracer_tpu_torch.parallel import leaf_shard

import torch_parallel_ranks as R

NODE_FIELDS = ("node_flag", "node_split", "node_right", "node_leaf_start", "node_leaf_lanes")
BLOCK_FIELDS = ("block_orig", "block_tris", "block_g")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(a):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.fixture(scope="module")
def soup():
    tv, tn = load_mesh_asset("teapot")
    return tv[:2000], tn[:2000], np.zeros((2000,), np.int32)


@pytest.fixture(scope="module")
def jax_scenes():
    """nmp -> JAX's stacked leaf-sharded scene of the leaf builder (its
    triangles and tree are ``jls.build_leaf_sharded_triangles``' of the
    soup)."""
    cfg = J.Config(**R.LEAF_CFG, tri_shard_axis="mp")
    return {nmp: jls.make_leaf_sharded_scene(R.leaf_builder(J), cfg, nmp) for nmp in (2, 4)}


def test_morton_order_equals_jax(soup):
    np.testing.assert_array_equal(leaf_shard._morton_order(soup[0]), jls._morton_order(soup[0]))


@pytest.mark.parametrize("nmp", [2, 4])
def test_shard_tables_equal_jax_slices(soup, jax_scenes, nmp):
    """Each shard's tables, then its blocks refreshed after a vertex
    update, equal the unpadded part of JAX's stacked slice bit for bit;
    ``local_scene_from_numpy`` of JAX's scene gives the same shard and the
    same whole-tree bounds and counts as the port's build."""
    j_tris, j_kd = jax_scenes[nmp].triangles, jax_scenes[nmp].kd
    j_shard = j_tris.verts.shape[1]
    j_arrays = R.numpy_tree(jax_scenes[nmp])
    rng = np.random.default_rng(0)
    moved = np.asarray(j_tris.verts) + rng.normal(0, 0.01, j_tris.verts.shape).astype(np.float32)
    j_refreshed = jls.refresh_kd_blocks_stacked(j_kd, jnp.asarray(moved))
    built = []
    for i in range(nmp):
        tris, kd, shard = leaf_shard.build_leaf_sharded_triangles(*soup, T.Config(**R.LEAF_CFG), nmp, i,
                                                                  device="cpu")
        assert shard == j_shard
        built.append(kd)
        for f in ("verts", "normals", "mesh_id"):
            np.testing.assert_array_equal(bits(getattr(tris, f)), bits(getattr(j_tris, f)[i]), err_msg=f)
        M, B = kd.node_flag.shape[0], kd.block_orig.shape[0]
        for f in NODE_FIELDS:
            np.testing.assert_array_equal(bits(getattr(kd, f)), bits(getattr(j_kd, f)[i][:M]), err_msg=f)
        for f in ("bounds_min", "bounds_max"):
            np.testing.assert_array_equal(bits(getattr(kd, f)), bits(getattr(j_kd, f)[i]), err_msg=f)
        np.testing.assert_array_equal(bits(kd.tri_perm), bits(j_kd.tri_perm[i][:kd.tri_perm.shape[0]]))
        for f in BLOCK_FIELDS:
            np.testing.assert_array_equal(bits(getattr(kd, f)), bits(getattr(j_kd, f)[i][:B]), err_msg=f)
        np.testing.assert_array_equal(bits(kd.block_aabb), bits(j_kd.block_aabb[i][:, :B]))
        assert not np.asarray(j_kd.block_orig[i][B:] >= 0).any()  # JAX's padding blocks are empty

        fresh = leaf_shard.refresh_kd_blocks_stacked(kd, torch.from_numpy(moved[i]))
        for f in ("block_tris", "block_g"):
            np.testing.assert_array_equal(bits(getattr(fresh, f)), bits(getattr(j_refreshed, f)[i][:B]), err_msg=f)
        np.testing.assert_array_equal(bits(fresh.block_aabb), bits(j_refreshed.block_aabb[i][:, :B]))

        local = leaf_shard.local_scene_from_numpy(j_arrays, i, None, device="cpu")
        np.testing.assert_array_equal(bits(local.kd.block_g[:B]), bits(kd.block_g))
        assert local.shard.offset == i * shard and local.shard.size == nmp and local.shard.index == i
    s = local.shard
    assert s.n_blocks == sum(k.block_orig.shape[0] for k in built)
    assert s.n_nodes == sum(k.node_flag.shape[0] for k in built)
    np.testing.assert_array_equal(bits(s.bounds_min), bits(torch.stack([k.bounds_min for k in built]).amin(0)))
    np.testing.assert_array_equal(bits(s.bounds_max), bits(torch.stack([k.bounds_max for k in built]).amax(0)))


def test_sharded_scene_needs_its_axis(jax_scenes):
    """A shard rendered without ``tri_shard_axis``, or with another axis
    name, raises before any walk (the unsharded scene's case:
    ``tests/test_torch_render.py``)."""
    scene = leaf_shard.local_scene_from_numpy(R.numpy_tree(jax_scenes[2]), 0, None, device="cpu")
    cfg = T.Config(**R.LEAF_CFG)
    with pytest.raises(ValueError, match="needs cfg.tri_shard_axis"):
        T.render_image(scene, cfg, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        T.render_image(scene, dataclasses.replace(cfg, tri_shard_axis="rows"), device="cpu")


