"""ctypes wrappers over the native (C++) host runtime.

Counterpart of ``dod_raytracer_tpu.native``: the SAH kd builder
(``kdtree_build.cpp``) and the OBJ parser (``objloader.cpp``), each built
with ``g++`` at first use (``build.py``).  A library that cannot be built
raises ``NativeUnavailable``; the callers then take the numpy builder
(``accel._kdtree_np.build``) or the Python parser (``mesh.load_obj``),
which have the same contract.  The compiler's error is logged once, at
WARNING, the first time a library fails to build.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess

import numpy as np

from . import build as _build

logger = logging.getLogger("dod_raytracer_tpu_torch")

_libs: dict = {}


class NativeUnavailable(RuntimeError):
    """A native library could not be built or loaded."""


def _load(name: str):
    """The loaded library ``name``, built if needed; raises
    ``NativeUnavailable`` (the first failure is logged at WARNING)."""
    lib = _libs.get(name)
    if isinstance(lib, NativeUnavailable):
        raise lib
    if lib is not None:
        return lib
    try:
        lib = ctypes.CDLL(_build.build(name)["path"])
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        err = NativeUnavailable(f"native library {name} unavailable: {e}")
        _libs[name] = err
        logger.warning("%s; falling back to the numpy/Python version", err)
        raise err from e
    _bind(name, lib)
    _libs[name] = lib
    return lib


def loaded(name: str) -> bool:
    """Whether library ``name`` was built and loaded in this process."""
    return isinstance(_libs.get(name), ctypes.CDLL)


def _bind(name: str, lib) -> None:
    if name == "kdtree_build":
        lib.kd_build.restype = ctypes.c_void_p
        lib.kd_build.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_double, ctypes.c_double, ctypes.c_double]
        for fn in ("kd_num_nodes", "kd_num_prims", "kd_max_leaf_lanes", "kd_max_depth"):
            getattr(lib, fn).restype = ctypes.c_int32
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.kd_copy.argtypes = [ctypes.c_void_p] * 7
        lib.kd_copy.restype = None
        lib.kd_free.argtypes = [ctypes.c_void_p]
        lib.kd_free.restype = None
    else:
        lib.obj_load.restype = ctypes.c_void_p
        lib.obj_load.argtypes = [ctypes.c_char_p]
        for fn in ("obj_num_verts", "obj_num_faces", "obj_has_normals"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.obj_copy.argtypes = [ctypes.c_void_p] * 4
        lib.obj_copy.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.obj_free.restype = None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class kdtree_native:
    """Native SAH builder (kdtree_build.cpp): the contract of
    ``accel._kdtree_np.build``, and the same tree bit for bit."""

    @staticmethod
    def build(tri_verts: np.ndarray, lane_size: int = 8, max_prims: int = 8,
              intersect_cost: float = 80.0, traversal_cost: float = 80.0,
              empty_bonus: float = 0.0):
        from ..accel import _kdtree_np

        lib = _load("kdtree_build")
        mins, maxs = _kdtree_np.lane_bounds(tri_verts, lane_size)
        mins = np.ascontiguousarray(mins, np.float32)
        maxs = np.ascontiguousarray(maxs, np.float32)
        h = lib.kd_build(_ptr(mins), _ptr(maxs), mins.shape[0], max_prims,
                         float(intersect_cost), float(traversal_cost), float(empty_bonus))
        try:
            m, k = lib.kd_num_nodes(h), lib.kd_num_prims(h)
            flag = np.empty(m, np.int32)
            split = np.empty(m, np.float32)
            right = np.empty(m, np.int32)
            leaf_start = np.empty(m, np.int32)
            leaf_lanes = np.empty(m, np.int32)
            prims = np.empty(k, np.int32)
            lib.kd_copy(h, *(_ptr(a) for a in (flag, split, right, leaf_start, leaf_lanes, prims)))
            return _kdtree_np.BuiltKD(
                node_flag=flag, node_split=split, node_right=right,
                node_leaf_start=leaf_start, node_leaf_lanes=leaf_lanes,
                bounds_min=mins.min(axis=0), bounds_max=maxs.max(axis=0),
                prim_nums=prims,
                max_leaf_lanes=int(lib.kd_max_leaf_lanes(h)),
                max_depth=int(lib.kd_max_depth(h)),
            )
        finally:
            lib.kd_free(h)


class objloader_native:
    """Native OBJ parser (objloader.cpp): the contract of
    ``mesh.load_obj``.  It rounds each decimal straight to float32
    (``strtof``); the Python parser rounds to float64, then to float32, so
    a vertex can differ in its last bit on rare inputs."""

    @staticmethod
    def load_obj(path: str):
        """-> (verts (V, 3) f32, faces (F, 3) i32, per-corner normals
        (F, 3, 3) f32 or None), or None if the file cannot be opened."""
        lib = _load("objloader")
        h = lib.obj_load(path.encode())
        if not h:
            return None
        try:
            nv, nf, has_n = lib.obj_num_verts(h), lib.obj_num_faces(h), lib.obj_has_normals(h)
            verts = np.empty((nv, 3), np.float32)
            faces = np.empty((nf, 3), np.int32)
            fnormals = np.empty((nf, 3, 3) if has_n else (0,), np.float32)
            lib.obj_copy(h, _ptr(verts), _ptr(faces), _ptr(fnormals))
            return verts, faces, (fnormals if has_n else None)
        finally:
            lib.obj_free(h)
