"""The port's PLY reader and ``load_mesh`` dispatch vs the JAX package.

The cases of ``tests/test_mesh.py:134-190`` (ascii, binary little and big
endian, vertex normals, a polygon fan-triangulated, PLY against the OBJ
pipeline) and a vertex element with its properties out of order: each
file goes through both packages' ``load_ply`` and ``load_mesh``, whose
arrays must be equal bit for bit.  Paths not ending in ``.ply`` are read
as OBJ by both.
"""

import numpy as np
import pytest

from dod_raytracer_tpu import mesh as jmesh
from dod_raytracer_tpu_torch import mesh as tmesh
from test_mesh import _PLY_ASCII, _write_binary_ply


def _same(a, b):
    """Equal bit for bit: both None, or arrays of one dtype, shape and bits."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _write_case(tmp_path, case):
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((9, 3)).astype(np.float32)
    path = tmp_path / f"{case}.ply"
    if case == "ascii":
        path.write_text(_PLY_ASCII)
    elif case in ("binary_le", "binary_be"):
        _write_binary_ply(str(path), verts, [(0, 1, 2), (2, 3, 4, 5), (6, 7, 8)],
                          endian="<" if case == "binary_le" else ">")
    elif case == "normals":
        normals = rng.standard_normal((9, 3)).astype(np.float32)
        _write_binary_ply(str(path), verts, [(0, 1, 2), (3, 4, 5), (6, 7, 8)], normals=normals)
    elif case == "polygon":  # a pentagon and a quad, ascii, with a scalar before the index list
        path.write_text("ply\nformat ascii 1.0\nelement vertex 6\nproperty float x\nproperty float y\n"
                        "property float z\nelement face 2\nproperty uchar flags\n"
                        "property list uchar int vertex_indices\nend_header\n"
                        + "".join(f"{x} {y} {z}\n" for x, y, z in verts[:6])
                        + "7 5 0 1 2 3 4\n1 4 1 3 5 2\n")
    elif case == "property_order":  # z, x, an extra float, y; double precision
        path.write_text("ply\nformat ascii 1.0\ncomment out of order\nelement vertex 4\nproperty double z\n"
                        "property double x\nproperty float confidence\nproperty double y\n"
                        "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
                        "0.5 0.125 9 0.25\n1.5 2.125 9 0.75\n0.25 1.0 9 3.5\n7.0 0.0 9 0.0\n4 0 1 2 3\n")
    return str(path)


@pytest.mark.parametrize("case", ["ascii", "binary_le", "binary_be", "normals", "polygon", "property_order"])
def test_load_ply_matches_jax(tmp_path, case):
    path = _write_case(tmp_path, case)
    got, ref = tmesh.load_ply(path), jmesh.load_ply(path)
    for a, b in zip(got, ref):
        _same(a, b)
    assert got[1].shape[0] >= 1
    for a, b in zip(tmesh.load_mesh(path), jmesh.load_mesh(path)):
        _same(a, b)


def test_load_ply_fan_and_normals(tmp_path):
    """The quad fans into (2, 3, 4), (2, 4, 5), and per-vertex normals
    reach load_mesh as given (tests/test_mesh.py:160-184)."""
    _, faces, vn = tmesh.load_ply(_write_case(tmp_path, "binary_be"))
    assert vn is None and faces.shape == (4, 3)
    np.testing.assert_array_equal(faces[1:3], [(2, 3, 4), (2, 4, 5)])
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    normals = np.tile(np.asarray([[0, 0, 1]], np.float32), (3, 1))
    _write_binary_ply(str(tmp_path / "tri.ply"), verts, [(0, 1, 2)], normals=normals)
    tv, tn = tmesh.load_mesh(str(tmp_path / "tri.ply"))
    np.testing.assert_array_equal(tv[0], verts)
    np.testing.assert_array_equal(tn[0], normals)


def test_load_mesh_ply_equals_obj_pipeline(tmp_path):
    """tests/test_mesh.py:187-207: a slice of the teapot as PLY and as OBJ
    through the join + smooth pipeline; the PLY arrays equal JAX's bit for
    bit, and the two formats agree."""
    tv_o, _ = tmesh.load_mesh_asset("teapot")
    verts, inv = np.unique(tv_o[:64].reshape(-1, 3), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    ply = str(tmp_path / "sub.ply")
    _write_binary_ply(ply, verts.astype(np.float32), faces.tolist())
    obj = tmp_path / "sub.obj"
    obj.write_text("".join("v {} {} {}\n".format(*(repr(float(x)) for x in v)) for v in verts)
                   + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces))
    got = tmesh.load_mesh(ply)
    for a, b in zip(got, jmesh.load_mesh(ply)):
        _same(a, b)
    tv_q, tn_q = tmesh.load_mesh(str(obj))
    np.testing.assert_allclose(got[0], tv_q, rtol=1e-6)
    np.testing.assert_allclose(got[1], tn_q, rtol=1e-5, atol=1e-6)


def test_load_mesh_reads_other_paths_as_obj(tmp_path):
    """Only .ply picks the PLY reader (any case); every other path is OBJ."""
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 4\n"
    for name in ("quad.mesh", "quad.OBJ", "quad"):
        (tmp_path / name).write_text(text)
        for a, b in zip(tmesh.load_mesh(str(tmp_path / name)), jmesh.load_mesh(str(tmp_path / name))):
            _same(a, b)
    (tmp_path / "quad.PLY").write_text(_PLY_ASCII)
    for a, b in zip(tmesh.load_mesh(str(tmp_path / "quad.PLY")), jmesh.load_mesh(str(tmp_path / "quad.PLY"))):
        _same(a, b)
    with pytest.raises(ValueError, match="not a PLY file"):
        (tmp_path / "bad.ply").write_text(text)
        tmesh.load_ply(str(tmp_path / "bad.ply"))
