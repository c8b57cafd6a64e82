"""Scene description and device-tensor scene representation.

Counterpart of ``dod_raytracer_tpu.scene``.  The reference keeps global SoA
registries per shape family, appended to by ``create()`` calls
(sphere.cpp:226-242, plane.cpp:204-222, cylinder.cpp:211-216,
triangle.cpp:262-292).  Here, as in the JAX package:

* ``SceneBuilder`` — host-side, mirrors the ``create()`` API and
  accumulates numpy rows;
* ``Scene`` — a dataclass of flat tensors on one device, built once by
  ``SceneBuilder.build(cfg, device)``; optionally carries kd-tree tensors.

Assembly is the same host numpy code with ``np.random.default_rng(seed)``,
so both packages build bit-identical scenes from one seed.  Empty families
are padded with one provably-miss primitive each (sphere radius 0, plane
normal 0, cylinder far away, all-zero triangle), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Spheres:
    """SoA sphere registry (sphere.cpp:12-23); radius stored un-squared."""

    center: torch.Tensor  # (S, 3) f32
    radius: torch.Tensor  # (S,) f32
    color: torch.Tensor  # (S, 3) f32


@dataclasses.dataclass
class Planes:
    """SoA infinite-plane registry (plane.cpp:11-20)."""

    point: torch.Tensor  # (P, 3) f32
    normal: torch.Tensor  # (P, 3) f32 — stored as given, NOT normalized (parity)
    color: torch.Tensor  # (P, 3) f32


@dataclasses.dataclass
class Cylinders:
    """Finite capped cylinders (cylinder.h:8-41); axis unit at creation."""

    base: torch.Tensor  # (C, 3) f32
    axis: torch.Tensor  # (C, 3) f32, unit
    radius: torch.Tensor  # (C,) f32
    height: torch.Tensor  # (C,) f32
    color: torch.Tensor  # (C, 3) f32


@dataclasses.dataclass
class Triangles:
    """Flat triangle soup (triangle.h:33-51) as (T, 3, 3) tensors.

    A welded mesh (``SceneBuilder.add_welded_mesh``) also keeps its joined
    vertex positions and face indices: the fit leaf
    'triangles.positions', from which ``mesh.derive`` computes ``verts``
    and ``normals``.  Both are None for a soup (the JAX package has
    neither)."""

    verts: torch.Tensor  # (T, 3, 3) f32 — [tri, corner(A/B/C), xyz]
    normals: torch.Tensor  # (T, 3, 3) f32 — per-vertex smooth normals
    mesh_id: torch.Tensor  # (T,) i32 — index into mesh_colors
    positions: Optional[torch.Tensor] = None  # (V, 3) f32 — joined positions of a welded mesh
    faces: Optional[torch.Tensor] = None  # (T, 3) i64 — indices into positions


@dataclasses.dataclass
class Lights:
    """Point lights {position, intensity} (light.h:4-8)."""

    position: torch.Tensor  # (L, 3) f32
    intensity: torch.Tensor  # (L,) f32


@dataclasses.dataclass
class KDArrays:
    """Flat kd-tree: the reference's packed nodes (kdtree.h:39-47) as
    parallel arrays, plus the leaf-contiguous triangle permutation
    (triangle.cpp:349-367) as a gather index, and the blocked leaf layout
    the traversals read (see ``accel.kdtree.refresh_kd_blocks``)."""

    node_flag: torch.Tensor  # (M,) i32 — 0/1/2 split axis, 3 leaf
    node_split: torch.Tensor  # (M,) f32 — split offset (interior)
    node_right: torch.Tensor  # (M,) i32 — right child index (interior)
    node_leaf_start: torch.Tensor  # (M,) i32 — first lane in perm (leaf)
    node_leaf_lanes: torch.Tensor  # (M,) i32 — lane count (leaf)
    bounds_min: torch.Tensor  # (3,) f32 — world bound (kdtree.cpp:78-91)
    bounds_max: torch.Tensor  # (3,) f32
    tri_perm: torch.Tensor  # (K*lane,) i32 — original tri per reordered slot, -1 pad
    block_orig: Optional[torch.Tensor] = None  # (B, S) i32, S = block_lanes*lane
    block_tris: Optional[torch.Tensor] = None  # (B, S, 9) f32 [A|e1|e2]
    block_g: Optional[torch.Tensor] = None  # (B, 16, 5*Spad) f32 Plücker matrices
    block_aabb: Optional[torch.Tensor] = None  # (6, B) f32 per-block vertex AABB
    # treelet forest of trees of more than treelet_cap nodes (the forest
    # kernel's input; accel._kdtree_np), int columns bit-cast into f32
    tre_tbl: Optional[torch.Tensor] = None  # (T, cap, 6) [flag|split|right|leaf_start|leaf_lanes|block0]
    top_tbl: Optional[torch.Tensor] = None  # (Ttop, 4) [flag|split|right|treelet]
    lane_size: int = 8
    num_lanes: int = 0  # reordered lane count K
    max_leaf_lanes: int = 0
    block_lanes: int = 0
    max_depth: int = 0  # build depth budget (kdtree.cpp:72)
    # the port's own: each lane's filing box (its triangles' boxes when it
    # was last filed, padded by ``margin``) and the build's Config, with
    # which ``accel.kdtree.follow_vertices`` keeps the tree conservative as
    # the vertices move; None for a tree from ``scene_from_numpy``
    lane_lo: Optional[torch.Tensor] = None  # (L, 3) f32, L = ceil(T / lane_size)
    lane_hi: Optional[torch.Tensor] = None  # (L, 3) f32
    margin: float = 0.0  # 0 at the build; set by the first re-filing
    build_cfg: Any = None


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    planes: Planes
    cylinders: Cylinders
    triangles: Triangles
    mesh_colors: torch.Tensor  # (M, 3) f32
    lights: Lights
    kd: Optional[KDArrays] = None
    # numbers of *real* (non-padding) primitives
    n_spheres: int = 0
    n_planes: int = 0
    n_cylinders: int = 0
    n_triangles: int = 0
    n_lights: int = 0
    # a leaf-sharded scene's rank: triangles and kd hold this rank's shard
    # only (``parallel.leaf_shard.LeafShard``: its process group, the
    # shard's place, the whole sharded tree's bounds and size); None for
    # a scene that holds every triangle
    shard: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return self.spheres.center.device


# dataclass-valued fields, for the numpy <-> Scene conversions
_NESTED = {"spheres": Spheres, "planes": Planes, "cylinders": Cylinders,
           "triangles": Triangles, "lights": Lights, "kd": KDArrays}


def _from_numpy(cls, arrays: dict, device):
    if cls is KDArrays and arrays.get("tre_tbl") is not None:
        from .accel._kdtree_np import tables_from_jax

        arrays = dict(arrays)
        arrays["tre_tbl"], arrays["top_tbl"] = tables_from_jax(arrays["tre_tbl"], arrays["top_tbl"])
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        v = arrays[f.name]
        if v is None:
            kw[f.name] = None
        elif f.name in _NESTED:
            kw[f.name] = _from_numpy(_NESTED[f.name], v, device)
        elif isinstance(v, np.ndarray):
            # a copy: arrays viewed from JAX buffers are read-only
            kw[f.name] = torch.from_numpy(np.array(v, copy=True)).to(device)
        else:
            kw[f.name] = int(v)
    return cls(**kw)


def scene_from_numpy(arrays: dict, device="cuda") -> Scene:
    """Port's ``Scene`` from the JAX ``Scene``'s leaves as numpy arrays.

    ``arrays`` nests like the dataclasses: ``{"spheres": {"center": ...},
    ..., "kd": {...} or None, "n_spheres": 16, ...}``.  The treelet
    tables come in the JAX package's 128-column float layout and are
    stored in the port's compact one (``accel._kdtree_np.tables_from_jax``).
    """
    return _from_numpy(Scene, arrays, device)


# port-only fields with no JAX counterpart: left out of scene_to_numpy while
# unset, and always for a tree's filing boxes, margin and build Config
_PORT_ONLY = ("positions", "faces")
TREE_FILING = ("lane_lo", "lane_hi", "margin", "build_cfg")


def scene_to_numpy(obj) -> Any:
    """Inverse of ``scene_from_numpy``: nested dict of numpy arrays/ints,
    with the treelet tables in the JAX package's layout.  A leaf-sharded
    scene's ``shard`` (its process group) is left out: it has no numpy
    form and no JAX counterpart; so are a soup's unset ``positions`` and
    ``faces``, and a tree's filing boxes, margin and build ``Config``."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: scene_to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)
               if f.name != "shard" and f.name not in TREE_FILING
               and not (f.name in _PORT_ONLY and getattr(obj, f.name) is None)}
        if isinstance(obj, KDArrays) and out["tre_tbl"] is not None:
            from .accel._kdtree_np import tables_to_jax

            out["tre_tbl"], out["top_tbl"] = tables_to_jax(out["tre_tbl"], out["top_tbl"])
        return out
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


class SceneBuilder:
    """Host-side scene assembly mirroring the reference ``create()`` APIs."""

    def __init__(self):
        self._spheres: list = []
        self._planes: list = []
        self._cylinders: list = []
        self._tri_verts: list = []
        self._tri_normals: list = []
        self._tri_mesh: list = []
        self._welded: list = []  # (positions (V, 3), faces (T, 3)) of each welded mesh
        self._mesh_colors: list = []
        self._lights: list = []

    # --- registries -------------------------------------------------------
    def add_sphere(self, position, radius, color) -> int:
        """Sphere::create (sphere.cpp:226-242)."""
        self._spheres.append((np.asarray(position, np.float32), np.float32(radius), np.asarray(color, np.float32)))
        return len(self._spheres) - 1

    def add_plane(self, position, normal, color) -> int:
        """Plane::create (plane.cpp:204-222). Normal stored as given."""
        self._planes.append((np.asarray(position, np.float32), np.asarray(normal, np.float32), np.asarray(color, np.float32)))
        return len(self._planes) - 1

    def add_cylinder(self, base, axis, radius, height, color) -> int:
        """Cylinder::create (cylinder.cpp:211-216); axis normalized here
        as in the Cylinder constructor (cylinder.cpp:224-230)."""
        axis = np.asarray(axis, np.float64)
        axis = (axis / np.linalg.norm(axis)).astype(np.float32)
        self._cylinders.append((np.asarray(base, np.float32), axis, np.float32(radius), np.float32(height), np.asarray(color, np.float32)))
        return len(self._cylinders) - 1

    def add_mesh(self, verts, normals, color=(0.1, 0.8, 0.3)) -> int:
        """Mesh::Create equivalent (mesh.cpp:9-50): (T, 3, 3) triangulated
        faces with per-vertex smooth normals; default color mesh.cpp:23."""
        verts = np.asarray(verts, np.float32)
        normals = np.asarray(normals, np.float32)
        if verts.ndim != 3 or verts.shape[1:] != (3, 3) or normals.shape != verts.shape:
            raise ValueError(f"mesh arrays must be (T, 3, 3): {verts.shape}, {normals.shape}")
        if self._welded:
            raise ValueError("a scene holds welded meshes or soups, not both")
        return self._add_triangles(verts, normals, color)

    def add_welded_mesh(self, positions, faces, color=(0.1, 0.8, 0.3)) -> int:
        """A mesh as the reference's import gives it before flattening
        (JoinIdenticalVertices | GenSmoothNormals, mesh.cpp:11-14): joined
        positions (V, 3) and faces (F, 3) into them (``mesh.load_welded``).
        The scene's corners and smooth normals derive from the positions
        (``mesh.derive``), which the fit leaf 'triangles.positions' moves.
        The corners equal the flattened mesh's bit for bit, the normals
        the loader's to float rounding."""
        positions = np.asarray(positions, np.float32)
        faces = np.asarray(faces, np.int64)
        if positions.ndim != 2 or positions.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
            raise ValueError(f"welded mesh arrays must be (V, 3) and (F, 3): {positions.shape}, {faces.shape}")
        if self._tri_verts and not self._welded:
            raise ValueError("a scene holds welded meshes or soups, not both")
        offset = sum(p.shape[0] for p, _ in self._welded)
        self._welded.append((positions, faces + offset))
        return self._add_triangles(positions[faces], None, color)

    def _add_triangles(self, verts, normals, color) -> int:
        mesh_id = len(self._mesh_colors)
        self._mesh_colors.append(np.asarray(color, np.float32))
        self._tri_verts.append(verts)
        self._tri_normals.append(normals)
        self._tri_mesh.append(np.full((verts.shape[0],), mesh_id, np.int32))
        return mesh_id

    def add_light(self, position, intensity) -> int:
        self._lights.append((np.asarray(position, np.float32), np.float32(intensity)))
        return len(self._lights) - 1

    # --- build ------------------------------------------------------------
    def build(self, cfg=None, device="cuda") -> Scene:
        from .config import Config

        cfg = cfg or Config()
        n_s, n_p, n_c, n_l = (len(self._spheres), len(self._planes), len(self._cylinders), len(self._lights))

        if self._spheres:
            sc = np.stack([s[0] for s in self._spheres])
            sr = np.array([s[1] for s in self._spheres], np.float32)
            scol = np.stack([s[2] for s in self._spheres])
        else:
            sc = np.zeros((1, 3), np.float32)
            sr = np.zeros((1,), np.float32)
            scol = np.zeros((1, 3), np.float32)

        if self._planes:
            pp = np.stack([p[0] for p in self._planes])
            pn = np.stack([p[1] for p in self._planes])
            pcol = np.stack([p[2] for p in self._planes])
        else:
            pp = np.zeros((1, 3), np.float32)
            pn = np.zeros((1, 3), np.float32)  # zero normal -> always miss
            pcol = np.zeros((1, 3), np.float32)

        if self._cylinders:
            cb = np.stack([c[0] for c in self._cylinders])
            ca = np.stack([c[1] for c in self._cylinders])
            cr = np.array([c[2] for c in self._cylinders], np.float32)
            ch = np.array([c[3] for c in self._cylinders], np.float32)
            ccol = np.stack([c[4] for c in self._cylinders])
        else:
            # finite padding; the n_cylinders mask rejects it
            cb = np.array([[0.0, 1.0e3, 0.0]], np.float32)
            ca = np.tile(np.array([0, 0, 1], np.float32), (1, 1))
            cr = np.zeros((1,), np.float32)
            ch = np.ones((1,), np.float32)
            ccol = np.zeros((1, 3), np.float32)

        if self._tri_verts:
            tv = np.concatenate(self._tri_verts, axis=0)
            tn = None if self._welded else np.concatenate(self._tri_normals, axis=0)
            tm = np.concatenate(self._tri_mesh, axis=0)
        else:
            tv = np.zeros((1, 3, 3), np.float32)  # degenerate: det == 0
            tn = np.zeros((1, 3, 3), np.float32)
            tm = np.zeros((1,), np.int32)
        n_t = sum(v.shape[0] for v in self._tri_verts)

        mcol = np.stack(self._mesh_colors) if self._mesh_colors else np.zeros((1, 3), np.float32)

        if self._lights:
            lp = np.stack([l[0] for l in self._lights])
            li = np.array([l[1] for l in self._lights], np.float32)
        else:
            lp = np.zeros((1, 3), np.float32)
            li = np.zeros((1,), np.float32)

        kd = None
        if cfg.use_kdtree and n_t > 0:
            from .accel.kdtree import build_kdtree

            kd = build_kdtree(tv, cfg, device)

        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if self._welded:
            from .mesh import derive

            positions = t(np.concatenate([p for p, _ in self._welded]))
            faces = t(np.concatenate([f for _, f in self._welded]))
            triangles = Triangles(*derive(positions, faces), t(tm), positions=positions, faces=faces)
        else:
            triangles = Triangles(t(tv), t(tn), t(tm))
        return Scene(
            spheres=Spheres(t(sc), t(sr), t(scol)),
            planes=Planes(t(pp), t(pn), t(pcol)),
            cylinders=Cylinders(t(cb), t(ca), t(cr), t(ch), t(ccol)),
            triangles=triangles,
            mesh_colors=t(mcol),
            lights=Lights(t(lp), t(li)),
            kd=kd,
            n_spheres=n_s,
            n_planes=n_p,
            n_cylinders=n_c,
            n_triangles=n_t,
            n_lights=n_l,
        )


def default_scene(seed: int = 0, cfg=None, num_spheres: int = 16, with_cylinder: bool = True,
                  mesh: Optional[str] = "dragon") -> SceneBuilder:
    """The reference's hardcoded scene recipe (main.cpp:26-146,283-292) with
    a seeded PRNG replacing ``srand(time(NULL))`` (main.cpp:351).

    Same draws in the same order as ``dod_raytracer_tpu.scene.default_scene``,
    so one seed gives both packages the same scene.  ``mesh`` is
    'dragon' (the default, as in the JAX package), 'teapot', an OBJ path
    or None.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(num_spheres):
        color = rng.random(3, dtype=np.float32)
        pos = rng.random(3, dtype=np.float32) * 10.0 - 5.0
        b.add_sphere(pos, 1.0, color)
    walls = [  # main.cpp:54-103 (normal, position, color)
        ((0.0, 0.0, -1.0), (0.0, 0.0, 5.0), (0.195, 0.410, 0.610)),
        ((0.0, 0.0, 1.0), (0.0, 0.0, -5.0), (0.493, 0.265, 0.590)),
        ((0.0, -1.0, 0.0), (0.0, 5.0, 0.0), (0.276, 0.600, 0.411)),
        ((0.0, 1.0, 0.0), (0.0, -5.0, 0.0), (0.292, 0.680, 0.674)),
        ((1.0, 0.0, 0.0), (-5.0, 0.0, 0.0), (0.720, 0.288, 0.389)),
        ((-1.0, 0.0, 0.0), (5.0, 0.0, 0.0), (0.680, 0.224, 0.224)),
    ]
    for normal, position, color in walls:
        b.add_plane(position, normal, color)
    if with_cylinder:
        b.add_cylinder(base=(-2.0, 0.0, 2.0), axis=(2.2, 5.0, 2.0), radius=1.5,
                       height=4.0, color=rng.random(3, dtype=np.float32))
    if mesh is not None:
        from .mesh import load_mesh_asset

        verts, normals = load_mesh_asset(mesh)
        b.add_mesh(verts, normals)
    for position, intensity in reference_lights():
        b.add_light(position, intensity)
    return b


def reference_lights() -> Sequence[Any]:
    """The 9 hardcoded point lights (main.cpp:283-292)."""
    return [
        ((0.0, 0.0, -2.0), 3.0),
        ((4.0, 4.3, 3.3), 1.0),
        ((-4.0, -2.95, 3.95), 1.0),
        ((3.95, -4.2, 3.3), 1.0),
        ((-2.9, 4.2, 3.8), 1.0),
        ((3.95, 2.8, -4.3), 1.0),
        ((-3.0, -3.8, -3.3), 1.0),
        ((4.2, -4.2, -3.4), 1.0),
        ((-2.9, 4.4, -3.5), 1.0),
    ]
