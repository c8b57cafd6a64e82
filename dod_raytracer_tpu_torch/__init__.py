"""dod_raytracer_tpu_torch — the PyTorch + CUDA port of dod_raytracer_tpu.

A Whitted ray tracer with the reference CPU tracer's semantics
(AVassilev98/dod_raytracer, see SURVEY.md): wavefront ray batches, fused
primitive intersection, a SAH kd tree walked by hand-written CUDA kernels
(``csrc/packet_traverse.cu``; ``csrc/kd_walk.cu``, the mega and forest
walks; ``csrc/block_loop.cu``, the binned walk's leaf stage), brute-force
intersection kernels (``csrc/mt_closest.cu``, ``csrc/plucker_closest.cu``),
Whitted shading with point lights and shadows.  Module names mirror ``dod_raytracer_tpu``; that JAX package is
the reference the port is tested against, and nothing here imports it.

Entry points run on the card by default (``device="cuda"``); pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
The subpackage ``parallel`` distributes a frame or a train step over
``torch.distributed`` ranks: rays over a 'dp' axis, triangles
leaf-sharded over an 'mp' one.
"""

from .config import Config
from .intersect import closest_hit, occluded
from .render import quantize_u8, render_image, render_rays
from .scene import Scene, SceneBuilder, default_scene, scene_from_numpy

__all__ = [
    "Config",
    "Scene",
    "SceneBuilder",
    "default_scene",
    "scene_from_numpy",
    "render_image",
    "render_rays",
    "quantize_u8",
    "closest_hit",
    "occluded",
]

__version__ = "0.1.0"
