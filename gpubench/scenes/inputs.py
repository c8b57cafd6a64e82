"""The benchmark's own inputs: a frozen copy of the reference scene's draws.

The reference binary (AVassilev98/dod_raytracer, ``src/main.cpp:26-146,
283-292``) places 16 unit spheres at random, six coloured walls, one capped
cylinder of random colour and 9 point lights, and loads one mesh.
``reference_draws`` repeats the port's ``default_scene`` draw for draw
(the same ``np.random.default_rng(seed)`` calls in the same order).  A
run's scene takes the spheres' places from one fixed draw and everything
else random from its seed (``scene_arrays``), and the program and the
plain reference get the same arrays.  The mesh files are
read here, by the benchmark, and checked against the SHA-256 that the
configuration file records.

Imports numpy only: the benchmark hands these arrays to the program
(``to_builder``) and to the reference alike.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .objreader import load_obj_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# main.cpp:54-103: (normal, position, colour) of the six walls of the box
WALLS = (
    ((0.0, 0.0, -1.0), (0.0, 0.0, 5.0), (0.195, 0.410, 0.610)),
    ((0.0, 0.0, 1.0), (0.0, 0.0, -5.0), (0.493, 0.265, 0.590)),
    ((0.0, -1.0, 0.0), (0.0, 5.0, 0.0), (0.276, 0.600, 0.411)),
    ((0.0, 1.0, 0.0), (0.0, -5.0, 0.0), (0.292, 0.680, 0.674)),
    ((1.0, 0.0, 0.0), (-5.0, 0.0, 0.0), (0.720, 0.288, 0.389)),
    ((-1.0, 0.0, 0.0), (5.0, 0.0, 0.0), (0.680, 0.224, 0.224)),
)
# main.cpp:283-292: (position, intensity) of the 9 point lights
LIGHTS = (
    ((0.0, 0.0, -2.0), 3.0),
    ((4.0, 4.3, 3.3), 1.0),
    ((-4.0, -2.95, 3.95), 1.0),
    ((3.95, -4.2, 3.3), 1.0),
    ((-2.9, 4.2, 3.8), 1.0),
    ((3.95, 2.8, -4.3), 1.0),
    ((-3.0, -3.8, -3.3), 1.0),
    ((4.2, -4.2, -3.4), 1.0),
    ((-2.9, 4.4, -3.5), 1.0),
)
# main.cpp's cylinder (base, axis as given, radius, height) and the mesh's
# default colour (mesh.cpp:23)
CYLINDER = ((-2.0, 0.0, 2.0), (2.2, 5.0, 2.0), 1.5, 4.0)
MESH_COLOR = (0.1, 0.8, 0.3)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load_mesh(scene_cfg: dict):
    """(verts (T, 3, 3) f32, normals (T, 3, 3) f32) of the configuration's
    mesh file, after checking the file's SHA-256 against the one recorded."""
    path = os.path.join(ROOT, scene_cfg["mesh_file"])
    got = sha256(path)
    if got != scene_cfg["mesh_sha256"]:
        raise RuntimeError(f"{scene_cfg['mesh_file']}: SHA-256 {got}, the configuration records "
                           f"{scene_cfg['mesh_sha256']}: the benchmark's input changed")
    return load_obj_mesh(path)


def reference_draws(seed: int, num_spheres: int = 16, with_cylinder: bool = True) -> tuple:
    """main.cpp's random draws in the port's ``default_scene`` order: each
    sphere's colour then its place, then the cylinder's colour ->
    (places (S, 3), colours (S, 3), cylinder colour (3,) or None)."""
    rng = np.random.default_rng(seed)
    col = np.zeros((num_spheres, 3), np.float32)
    pos = np.zeros((num_spheres, 3), np.float32)
    for i in range(num_spheres):
        col[i] = rng.random(3, dtype=np.float32)
        pos[i] = rng.random(3, dtype=np.float32) * 10.0 - 5.0
    return pos, col, (rng.random(3, dtype=np.float32) if with_cylinder else None)


def scene_arrays(scene_cfg: dict, seed: int, mesh=None) -> dict:
    """Every input of a frame as numpy arrays.

    The spheres stand where ``reference_draws(layout_seed)`` puts them, so
    that every seed gives the program the same work; ``seed`` deals those
    places out to the spheres in another order and draws every colour
    (the spheres' and the cylinder's).  ``mesh``: the (verts, normals) of
    ``load_mesh``, read once per process.  The cylinder's axis is kept as
    given; the program and the reference each normalise it."""
    s = int(scene_cfg["num_spheres"])
    cyl = bool(scene_cfg.get("with_cylinder", True))
    places, _, _ = reference_draws(int(scene_cfg["layout_seed"]), s, cyl)
    order = np.random.default_rng([seed, 0]).permutation(s)
    _, s_col, c_col = reference_draws(seed, s, cyl)
    out = dict(
        sphere_center=places[order], sphere_radius=np.ones((s,), np.float32), sphere_color=s_col,
        plane_point=np.array([w[1] for w in WALLS], np.float32),
        plane_normal=np.array([w[0] for w in WALLS], np.float32),
        plane_color=np.array([w[2] for w in WALLS], np.float32),
        light_position=np.array([l[0] for l in LIGHTS], np.float32),
        light_intensity=np.array([l[1] for l in LIGHTS], np.float32),
    )
    if cyl:
        base, axis, radius, height = CYLINDER
        out.update(cylinder_base=np.array([base], np.float32), cylinder_axis=np.array([axis], np.float64),
                   cylinder_radius=np.array([radius], np.float32), cylinder_height=np.array([height], np.float32),
                   cylinder_color=c_col[None])
    if mesh is not None:
        out.update(mesh_verts=mesh[0], mesh_normals=mesh[1], mesh_color=np.array([MESH_COLOR], np.float32))
    return out


def to_builder(port, arrays: dict):
    """The program's ``SceneBuilder`` filled with ``arrays`` through its
    public ``add_*`` calls (``port`` is the imported program package)."""
    b = port.SceneBuilder()
    for c, r, col in zip(arrays["sphere_center"], arrays["sphere_radius"], arrays["sphere_color"]):
        b.add_sphere(c, r, col)
    for p, n, col in zip(arrays["plane_point"], arrays["plane_normal"], arrays["plane_color"]):
        b.add_plane(p, n, col)
    if "cylinder_base" in arrays:
        for args in zip(arrays["cylinder_base"], arrays["cylinder_axis"], arrays["cylinder_radius"],
                        arrays["cylinder_height"], arrays["cylinder_color"]):
            b.add_cylinder(*args)
    if "mesh_verts" in arrays:
        b.add_mesh(arrays["mesh_verts"], arrays["mesh_normals"], arrays["mesh_color"][0])
    for p, i in zip(arrays["light_position"], arrays["light_intensity"]):
        b.add_light(p, i)
    return b
