"""Scenes and rays for the families' any-hit and closest-hit tests: the
plain versions on the CPU (tests/test_torch_families.py, against the JAX
package too) and the kernels on the card (tests/test_torch_cuda.py).
Imports neither JAX nor the JAX package.

``hard_scene`` is exact geometry (integer positions, axis-aligned unit
normals and axes), so the hand-made rays of ``HARD_RAYS`` compute their
tests without rounding and their answers are known: origin inside a
sphere, a tangent ray, rays parallel to a wall, rays along the cylinder's
axis onto each cap and its rim, the body from the side, ``t_max`` exactly
at a hit and one ulp past it, killed lanes, a radius-0 sphere, a
zero-normal plane and a cylinder column past ``n_cylinders``.

``tie_scene`` is exact too, and its rays ``TIE_RAYS`` meet equal t in two
spheres, a sphere and a plane, a sphere and a cylinder's body or cap, a
plane and a cap, and two cylinders: their closest-hit winners are known.
"""

import dataclasses

import numpy as np

EPS = 1e-4
INF = float("inf")
NEXT_4 = float(np.nextafter(np.float32(4.0), np.float32(np.inf)))
NEXT_HALF = float(np.nextafter(np.float32(0.5), np.float32(np.inf)))
NEAR_RIM = float(np.nextafter(np.float32(-2.0), np.float32(0.0)))  # 1 ulp inside x = -2: just off the rim

# (origin, direction, t_max, blocked), each blocked bit derived by hand
HARD_RAYS = [
    ((0, 0, 5), (0, 0, 1), 3.0, False),  # origin at the centre of sphere A: never hits it
    ((0, 0, 5), (0, 0, 1), 6.0, True),  # ... the wall z = 10 at t = 5 does
    ((0, 0, 4), (0, 0, 1), 8.0, True),  # origin on A's surface (|L|^2 = r^2): the wall at t = 6
    ((1, 0, 0), (0, 0, 1), 8.0, False),  # tangent to A (d2 = r^2: strict)
    ((1, 0, 0), (0, 0, 1), 11.0, True),  # ... the wall at t = 10
    ((0, 0, 0), (0, 0, 1), 4.0, False),  # A's near root at t = 4 = t_max (strict)
    ((0, 0, 0), (0, 0, 1), NEXT_4, True),  # one ulp past it
    ((-4.5, 0, 0), (0, 1, 0), 100.0, False),  # parallel to the walls x = -5 and z = 10
    ((-3, 0, -2), (0, 0, 1), 2.0, False),  # along cylinder 0's axis: cap z = 0 at t = 2 = t_max
    ((-3, 0, -2), (0, 0, 1), 2.5, True),  # ... past it
    ((-3, 0, 4), (0, 0, -1), 2.0, False),  # down the axis: cap z = 2 at t = 2 = t_max
    ((-3, 0, 4), (0, 0, -1), 2.5, True),  # ... past it
    ((-2, 0, -2), (0, 0, 1), 2.5, True),  # onto the rim of cap z = 0 (|q|^2 = r^2)
    ((NEAR_RIM, 0, -2), (0, 0, 1), 3.0, False),  # 1 ulp outside the rim
    ((-4.5, 0, 1), (1, 0, 0), 10.0, True),  # cylinder 0's body at t = 0.5
    ((-4.5, 0, 1), (1, 0, 0), 0.5, False),  # ... t_max exactly there
    ((-4.5, 0, 1), (1, 0, 0), NEXT_HALF, True),  # ... one ulp past it
    ((0, 3, 0), (0, 0, 1), 8.0, False),  # straight at the radius-0 sphere's centre
    ((0, -3, 0), (0, 0, 1), 9.0, False),  # through the zero-normal plane's point
    ((3, 0, -2), (0, 0, 1), 3.0, False),  # cylinder 1 (past n_cylinders): its cap at t = 2
    ((4.5, 0, 1), (-1, 0, 0), 1.0, False),  # ... its body at t = 0.5
    ((0, 0, 0), (0, 0, 1), -1.0, False),  # killed lanes: A ahead, at t = 4
    ((-4.5, 0, 1), (1, 0, 0), -1.0, False),
    ((0, 0, 0), (0, 0, 1), 0.0, False),
    ((0, 0, 0), (0, 0, 1), float("nan"), False),
]


def hard_scene(pkg, **build_kw):
    """The exact scene in package ``pkg`` (the port: pass ``device``):
    sphere A (centre (0, 0, 5), radius 1) and a radius-0 sphere at (0, 3, 5);
    the walls z = 10 (normal -z) and x = -5 (normal +x) and a zero-normal
    plane at (0, -3, 3); cylinder 0 (base (-3, 0, 0), axis +z, radius 1,
    height 2) and cylinder 1, the same at x = 3, past ``n_cylinders`` = 1."""
    b = pkg.SceneBuilder()
    b.add_sphere((0, 0, 5), 1.0, (1, 0, 0))
    b.add_sphere((0, 3, 5), 0.0, (0, 1, 0))
    b.add_plane((0, 0, 10), (0, 0, -1), (1, 1, 1))
    b.add_plane((-5, 0, 0), (1, 0, 0), (1, 1, 1))
    b.add_plane((0, -3, 3), (0, 0, 0), (1, 1, 1))
    b.add_cylinder((-3, 0, 0), (0, 0, 1), 1.0, 2.0, (0, 0, 1))
    b.add_cylinder((3, 0, 0), (0, 0, 1), 1.0, 2.0, (0, 0, 1))
    b.add_light((0, 0, 9), 1.0)
    scene = b.build(pkg.Config(use_kdtree=False), **build_kw)
    return dataclasses.replace(scene, n_cylinders=1)


def tie_scene(pkg, **build_kw):
    """Two equal spheres (centre (0, 0, 5), radius 1), the plane z = 4
    (normal -z) and two equal cylinders (base (0, 0, 4), axis +z, radius 1,
    height 2), every one real."""
    b = pkg.SceneBuilder()
    for _ in range(2):
        b.add_sphere((0, 0, 5), 1.0, (1, 0, 0))
    b.add_plane((0, 0, 4), (0, 0, -1), (0, 1, 0))
    for _ in range(2):
        b.add_cylinder((0, 0, 4), (0, 0, 1), 1.0, 2.0, (0, 0, 1))
    b.add_light((0, 0, 9), 1.0)
    return b.build(pkg.Config(use_kdtree=False), **build_kw)


NEXT_2 = float(np.nextafter(np.float32(2.0), np.float32(np.inf)))
SPHERE, PLANE, CYLINDER = 0, 1, 2
BODY, CAP_BASE, CAP_TOP = 0, 1, 2

# (origin, direction, t_max, winner (family, row, kind) or None for a miss, t), each derived by hand
TIE_RAYS = [
    ((0, 0, 0), (0, 0, 1), INF, (SPHERE, 0, 0), 4.0),  # sphere, plane and base cap all at t = 4
    ((0.5, 0, 0), (0, 0, 1), INF, (PLANE, 0, 0), 4.0),  # plane and base cap at 4, the sphere later
    ((0.5, 0, 0), (0, 0, 1), 4.0, None, INF),  # ... t_max exactly there
    ((0.5, 0, 0), (0, 0, 1), NEXT_4, (PLANE, 0, 0), 4.0),  # ... one ulp past it
    ((0.5, 0, 4.5), (0, 0, 1), INF, (CYLINDER, 0, CAP_TOP), 1.5),  # inside both: the top caps tie
    ((-3, 0, 5), (1, 0, 0), INF, (SPHERE, 0, 0), 2.0),  # sphere and both bodies at t = 2
    ((-3, 0, 5), (1, 0, 0), 2.0, None, INF),  # ... t_max exactly there
    ((-3, 0, 5), (1, 0, 0), NEXT_2, (SPHERE, 0, 0), 2.0),  # ... one ulp past it
    ((-3, 0, 4.5), (1, 0, 0), INF, (CYLINDER, 0, BODY), 2.0),  # the bodies tie, the sphere later
    ((0.5, 0, 10), (0, 0, -1), INF, (CYLINDER, 0, CAP_TOP), 4.0),  # the top caps, then sphere and plane
    ((0, 0, 10), (0, 0, -1), INF, (SPHERE, 0, 0), 4.0),  # sphere and top caps at t = 4
    ((0, 0, 0), (0, 0, 1), -1.0, None, INF),  # a killed ray
]


def tie_rays():
    """``TIE_RAYS`` as o, d (N, 3), t_max (N,) float32, the winner codes
    (N,) int32 (-1 a miss; ``ops/families.py``) and t (N,) float32."""
    o, d, t_max, win, t = zip(*TIE_RAYS)
    code = [-1 if w is None else w[1] << 4 | w[2] << 2 | w[0] for w in win]
    return (np.array(o, np.float32), np.array(d, np.float32), np.array(t_max, np.float32),
            np.array(code, np.int32), np.array(t, np.float32))


def many_scene(pkg, device):
    """300 spheres, 140 planes and 70 cylinders of which 67 are real: more
    than one staged chunk of each family (256, 128, 64 rows)."""
    rng = np.random.default_rng(21)
    b = pkg.SceneBuilder()
    for _ in range(300):
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.05, 0.6), (1, 1, 1))
    for _ in range(140):
        nrm = rng.standard_normal(3)
        b.add_plane(nrm / np.linalg.norm(nrm) * rng.uniform(9, 40), nrm, (1, 1, 1))
    for _ in range(70):
        b.add_cylinder(rng.uniform(-8, 8, 3), rng.standard_normal(3), rng.uniform(0.1, 0.8), rng.uniform(0.5, 3),
                       (1, 1, 1))
    return dataclasses.replace(b.build(pkg.Config(use_kdtree=False), device=device), n_cylinders=67)


def hard_rays():
    """``HARD_RAYS`` as float32 arrays: o, d (N, 3), t_max (N,), blocked (N,)."""
    o, d, t, hit = zip(*HARD_RAYS)
    return (np.array(o, np.float32), np.array(d, np.float32), np.array(t, np.float32), np.array(hit))


def random_rays(seed, n, spread=6.0):
    """n rays from the seed: origins in a cube of half-side ``spread``, half
    of them aimed at a point near a sphere or cylinder of ``hard_scene``,
    t_max inf, uniform in (0, 12) or -1 (killed), a third each."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * spread).astype(np.float32)
    targets = np.array([(0, 0, 5), (-3, 0, 1), (3, 0, 1)], np.float32)
    aim = targets[rng.integers(0, 3, n)] + rng.standard_normal((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2] = aim[: n // 2] - o[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.choose(rng.integers(0, 3, n), [np.full(n, np.inf), rng.random(n) * 12, np.full(n, -1.0)])
    return o, d.astype(np.float32), t_max.astype(np.float32)


def at_hit(t_first):
    """t_max that put each ray's first family hit ``t_first`` (inf where
    none) exactly at its clip (even rows) and one ulp past it (odd rows);
    rays with no hit keep t_max inf."""
    t = np.asarray(t_first, np.float32).copy()
    up = np.nextafter(t, np.float32(np.inf))
    t[1::2] = up[1::2]
    return np.where(np.isfinite(t_first), t, np.float32(np.inf)).astype(np.float32)


def first_hit_t(scene, o, d, eps):
    """(N,) the least candidate t over the port's plain family tests with
    no clip (inf where none): the t a ray meets its first blocker at."""
    import torch

    from dod_raytracer_tpu_torch.ops import cylinder, plane, sphere

    inf = torch.full((o.shape[0],), float("inf"), device=o.device)
    ts = [sphere.sphere_candidate_t(scene.spheres.center, scene.spheres.radius, o, d),
          plane.plane_candidate_t(scene.planes.point, scene.planes.normal, o, d, eps),
          cylinder.cylinder_candidate_t(scene.cylinders, o, d, inf, eps, scene.n_cylinders).reshape(o.shape[0], -1)]
    return torch.cat(ts, dim=1).min(dim=1).values
