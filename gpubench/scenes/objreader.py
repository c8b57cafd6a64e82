"""The benchmark's own OBJ reader: a frozen copy of the reference's mesh import.

The reference binary imports a mesh with assimp (``mesh.cpp:11-14``:
Triangulate | JoinIdenticalVertices | GenSmoothNormals) and flattens it to
per-face corners (``mesh.cpp:36-48``).  This is that pipeline in numpy:
``v``/``vn``/``f`` records, fan triangulation, exact-position vertex
joining, smooth normals as the normalised sum of adjacent unit face
normals.  Frozen here so that the benchmark's inputs do not move with the
program's loader.
"""

from __future__ import annotations

import numpy as np


def parse_obj(path: str):
    """-> (verts (V, 3) f32, faces (F, 3) i32, per-face normals (F, 3, 3) f32 or None)."""
    verts, normals, faces, face_normals = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vn "):
                p = line.split()
                normals.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                idx, nidx = [], []
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
        vn = np.asarray(normals, np.float32)[np.asarray(face_normals, np.int32)]
    return v, fc, vn


def smooth_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex normalize(sum of adjacent unit face normals); degenerate
    faces add nothing."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(b - a, c - a)
    ln = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = np.divide(fn, ln, out=np.zeros_like(fn), where=ln > 0)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.divide(vn, ln, out=np.zeros_like(vn), where=ln > 0)
    return vn.astype(np.float32)


def load_obj_mesh(path: str):
    """-> (verts (T, 3, 3) f32, normals (T, 3, 3) f32): the mesh as the
    renderer's triangle soup, one row per face corner in A/B/C order."""
    verts, faces, vn = parse_obj(path)
    if vn is not None:
        return verts[faces].astype(np.float32), vn.astype(np.float32)
    uniq, inverse = np.unique(verts, axis=0, return_inverse=True)
    verts, faces = uniq.astype(np.float32), inverse.astype(np.int32).reshape(-1)[faces]
    normals = smooth_normals(verts, faces)
    return verts[faces].astype(np.float32), normals[faces].astype(np.float32)
