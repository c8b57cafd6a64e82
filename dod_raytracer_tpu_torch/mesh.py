"""Host-side mesh pipeline: OBJ and PLY loading, vertex joining, smooth normals.

Counterpart of ``dod_raytracer_tpu.mesh`` (the reference's assimp import,
``mesh.cpp:11-14``: Triangulate | JoinIdenticalVertices | GenSmoothNormals,
and the per-face flattening of ``mesh.cpp:36-48``), in numpy and the
native OBJ parser:

* ``load_obj``       — OBJ parser (v / vn / f, fan triangulation): the
  C++ parser of ``native/`` when it builds, else the Python one.
* ``load_ply``       — PLY parser (ascii, binary little and big endian).
* ``join_identical`` — exact-position vertex dedup.
* ``smooth_normals`` — per-vertex average of adjacent unit face normals.
* ``mesh_to_triangles`` — flatten to the renderer's (T, 3, 3) soup.
* ``load_welded``    — the joined positions and faces, before flattening.
* ``derive``         — corners and smooth normals from joined positions, in
  torch and in autograd (a welded mesh's, ``scene.Triangles.positions``).
* ``procedural_dragon`` — the deterministic 869,952-triangle dragon
  stand-in that ``bench.py`` renders (committed as ``assets/dragon_proc.npz``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .native import NativeUnavailable, objloader_native
from .utils.profiling import span

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def load_obj(path: str, use_native: bool = True):
    """Parse an OBJ file -> (verts (V,3) f32, faces (F,3) i32, vn or None).

    Supports ``v``, ``vn`` and ``f`` records; face vertices may be ``i``,
    ``i/t``, ``i//n`` or ``i/t/n`` and may be negative (relative); polygons
    are fan-triangulated (aiProcess_Triangulate equivalent).  With
    ``use_native`` the C++ parser (``native/objloader.cpp``) reads the
    file when its library builds; this Python parser is its fallback and
    oracle.
    """
    if use_native:
        try:
            out = objloader_native.load_obj(path)
        except NativeUnavailable:  # logged once at WARNING by native._load
            out = None
        if out is not None:
            return out
    verts, normals, faces, face_normals = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vn "):
                parts = line.split()
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                nidx = []
                for p in line.split()[1:]:
                    comps = p.split("/")
                    vi = int(comps[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(comps) >= 3 and comps[2]:
                        ni = int(comps[2])
                        nidx.append(ni - 1 if ni > 0 else len(normals) + ni)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    if len(nidx) == len(idx):
                        face_normals.append((nidx[0], nidx[k], nidx[k + 1]))
    v = np.asarray(verts, np.float32)
    fc = np.asarray(faces, np.int32)
    vn = None
    if normals and len(face_normals) == len(faces):
        vn = np.asarray(normals, np.float32)[np.asarray(face_normals, np.int32)]  # (F,3,3)
    return v, fc, vn


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    """Parse a PLY file -> (verts (V,3) f32, faces (F,3) i32, vn or None).

    Handles ``format ascii/binary_little_endian/binary_big_endian 1.0``,
    arbitrary per-vertex property order (x/y/z picked out; nx/ny/nz kept
    when present), and list-typed face properties with fan triangulation
    of polygons (aiProcess_Triangulate equivalent).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', ct, it)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append((parts[4], "list", parts[2], parts[3]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        endian = "<" if fmt != "binary_big_endian" else ">"

        verts = normals = None
        faces = []
        for name, count, props in elements:
            if name == "vertex":
                names = [p[0] for p in props]
                if any(p[1] == "list" for p in props):
                    raise ValueError(f"{path}: list property on vertex element")
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [f.readline() for _ in range(count)],
                        dtype=np.float64, ndmin=2)
                else:
                    dt = np.dtype([(p[0], endian + _PLY_TYPES[p[1]])
                                   for p in props])
                    raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    rows = np.stack([raw[n].astype(np.float64) for n in names],
                                    axis=1)
                idx = {n: i for i, n in enumerate(names)}
                verts = rows[:, [idx["x"], idx["y"], idx["z"]]].astype(np.float32)
                if all(k in idx for k in ("nx", "ny", "nz")):
                    normals = rows[:, [idx["nx"], idx["ny"], idx["nz"]]].astype(np.float32)
            elif name == "face":
                list_props = [p for p in props if p[1] == "list"]
                if not list_props:
                    raise ValueError(f"{path}: face element has no list property")
                if fmt != "ascii" and len(props) != 1:
                    raise ValueError(
                        f"{path}: extra binary face properties unsupported")
                # scalar props may precede the index list (each is one
                # ascii token per row); the count token sits after them
                lead = props.index(list_props[0])
                for _ in range(count):
                    if fmt == "ascii":
                        nums = f.readline().split()
                        k = int(nums[lead])
                        idx = [int(x) for x in nums[lead + 1:lead + 1 + k]]
                    else:
                        cnt_t = endian + _PLY_TYPES[list_props[0][2]]
                        idx_t = endian + _PLY_TYPES[list_props[0][3]]
                        k = int(np.frombuffer(
                            f.read(np.dtype(cnt_t).itemsize), dtype=cnt_t)[0])
                        idx = np.frombuffer(
                            f.read(np.dtype(idx_t).itemsize * k), dtype=idx_t)
                    for j in range(1, k - 1):  # fan triangulation
                        faces.append((int(idx[0]), int(idx[j]), int(idx[j + 1])))
            else:
                # skip unknown elements (ascii: line-per-row; binary: fixed)
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    if any(p[1] == "list" for p in props):
                        raise ValueError(
                            f"{path}: cannot skip binary list element {name!r}")
                    dt = np.dtype([(p[0], endian + _PLY_TYPES[p[1]])
                                   for p in props])
                    f.read(dt.itemsize * count)
    if verts is None:
        raise ValueError(f"{path}: PLY file has no vertex element")
    fc = np.asarray(faces, np.int32).reshape(-1, 3)
    vn = normals[fc] if normals is not None else None  # (F,3,3) like load_obj
    return verts, fc, vn


def join_identical(verts: np.ndarray, faces: np.ndarray):
    """Merge exactly-coincident vertices (aiProcess_JoinIdenticalVertices)."""
    uniq, inverse = np.unique(verts, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inverse.astype(np.int32).reshape(-1)[faces]


def smooth_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex smooth normals: normalize(sum of adjacent unit face
    normals) — aiProcess_GenSmoothNormals at the default (all-smoothing)
    angle.  Degenerate faces contribute zero."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    fn = np.cross(b - a, c - a)
    ln = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = np.divide(fn, ln, out=np.zeros_like(fn), where=ln > 0)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.divide(vn, ln, out=np.zeros_like(vn), where=ln > 0)
    return vn.astype(np.float32)


def mesh_to_triangles(verts: np.ndarray, faces: np.ndarray, vertex_normals: np.ndarray):
    """Flatten to the renderer's soup: ((T,3,3) verts, (T,3,3) normals),
    one row per face corner in A/B/C order (triangle.cpp:262-292)."""
    tv = verts[faces]  # (T, 3, 3)
    tn = vertex_normals[faces]
    return tv.astype(np.float32), tn.astype(np.float32)


def derive(positions, faces):
    """(verts (T, 3, 3), normals (T, 3, 3)) of a welded mesh from its joined
    positions (V, 3) and faces (T, 3) (int64), on their device and in
    autograd: the corners by a gather (bit-equal to ``mesh_to_triangles``),
    the smooth normals by ``smooth_normals``' rule, normalize(sum of the
    adjacent unit face normals), degenerate faces adding nothing.  Its
    backward scatters the corners' and the normals' gradients into the
    positions."""
    with span("mesh.derive"):
        verts = positions[faces]
        a, b, c = verts.unbind(1)
        fn = torch.linalg.cross(b - a, c - a, dim=-1)
        fn = _unit(fn)
        vn = torch.zeros_like(positions)
        for k in range(3):
            vn = vn.index_add(0, faces[:, k], fn)
        return verts, _unit(vn)[faces]


def _unit(x):
    """x / |x| by rows, 0 where |x| = 0 (with a zero gradient there)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > 0, x / torch.where(n > 0, n, 1.0), 0.0)


def load_welded(path: str):
    """-> (positions (V, 3) f32, faces (F, 3) i32): a mesh file's joined
    positions and faces, as the reference's import holds them before it
    flattens them (``join_identical`` of ``load_obj`` / ``load_ply``).  The
    file's own normals are not read: a welded mesh's normals follow its
    positions (``derive``).  'teapot' names the committed asset."""
    if path == "teapot":
        path = os.path.join(_ASSET_DIR, "teapot.obj")
    loader = load_ply if path.lower().endswith(".ply") else load_obj
    verts, faces, _ = loader(path)
    return join_identical(verts, faces)


def load_mesh(path: str):
    """assimp-equivalent pipeline for one mesh file: ``.ply`` paths are
    read as PLY, every other path as OBJ (the JAX package's dispatch)."""
    loader = load_ply if path.lower().endswith(".ply") else load_obj
    verts, faces, vn_per_face = loader(path)
    if vn_per_face is not None:
        return verts[faces].astype(np.float32), vn_per_face.astype(np.float32)
    verts, faces = join_identical(verts, faces)
    vn = smooth_normals(verts, faces)
    return mesh_to_triangles(verts, faces, vn)


def procedural_dragon(num_tris: int = 869_888, seed: int = 7):
    """Deterministic high-poly dragon stand-in: a trefoil-knot tube with
    radial displacement ripples, scaled into the reference's +-5 box.

    (p, q) = (3, 2) torus knot; ``num_tris`` rounds to segments*rings*2.
    The same float64 numpy arithmetic as the JAX package's, so the two
    give the same bits.
    """
    rings = 368
    segs = max(4, int(round(num_tris / (2 * rings))))
    t = np.linspace(0.0, 2.0 * np.pi, segs, endpoint=False, dtype=np.float64)
    p, q = 3.0, 2.0
    r = np.cos(q * t) + 2.0
    center = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1)
    # Frenet-ish frame
    dt = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    tang = dt / np.linalg.norm(dt, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tang, up)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    up2 = np.cross(side, tang)

    theta = np.linspace(0.0, 2.0 * np.pi, rings, endpoint=False, dtype=np.float64)
    tube_r = 0.55 + 0.12 * np.sin(9.0 * t)[:, None] + 0.05 * np.cos(7.0 * theta)[None, :]
    circ = (
        center[:, None, :]
        + tube_r[..., None] * (np.cos(theta)[None, :, None] * side[:, None, :]
                               + np.sin(theta)[None, :, None] * up2[:, None, :])
    )  # (segs, rings, 3)
    circ *= 1.05  # scale into the box, teapot-like footprint
    verts = circ.reshape(-1, 3).astype(np.float32)

    i = np.arange(segs)[:, None]
    j = np.arange(rings)[None, :]
    v00 = (i * rings + j).ravel()
    v01 = (i * rings + (j + 1) % rings).ravel()
    v10 = (((i + 1) % segs) * rings + j).ravel()
    v11 = (((i + 1) % segs) * rings + (j + 1) % rings).ravel()
    faces = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)], axis=0
    ).astype(np.int32)
    vn = smooth_normals(verts, faces)
    return mesh_to_triangles(verts, faces, vn)


def load_mesh_asset(name: str):
    """Named asset loader: 'teapot' (the committed reference mesh),
    'dragon' (the procedural stand-in, read from the committed
    ``assets/dragon_proc.npz``; built in memory when that file is missing,
    and never written back) or a mesh path (``load_mesh``)."""
    if name == "teapot":
        return load_mesh(os.path.join(_ASSET_DIR, "teapot.obj"))
    if name == "dragon":
        cache = os.path.join(_ASSET_DIR, "dragon_proc.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                return z["verts"], z["normals"]
        return procedural_dragon()
    return load_mesh(name)
