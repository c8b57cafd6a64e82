"""Typed render/runtime configuration.

Same keys, defaults and ini format as ``dod_raytracer_tpu.config`` (the
reference's ``Config`` + loader, ``src/utils/config.h:4-38``,
``src/utils/config_loader.h:10-72``), so one ini file or override set
drives both packages.  Knobs that only steer the JAX package's TPU
kernels (``forest_tile``, ``packet_tile``, ``fold_groups``, ``dma_fifo``)
keep their fields here so configs stay interchangeable, and do nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # --- reference-parity keys (src/utils/config.h:6-14 defaults) ---
    Height: int = 1080
    Width: int = 1920
    Epsilon: float = 1.0e-4
    FrustrumMax: float = 1000.0  # loaded-but-unused in the reference; kept for parity
    IntersectCost: int = 80
    TraversalCost: int = 80
    EmptyBonus: float = 0.0
    MaxPrims: int = 8  # kd-tree: max *lanes* per leaf before forced split attempt

    # --- renderer knobs ---
    recursion_depth: int = 10  # reference hardcodes 10 (src/main.cpp:301)
    # rays per render tile; 0 = auto (render._auto_ray_tile)
    ray_tile: int = 32768
    lane_size: int = 8  # triangles per kd-tree lane (reference c_triangleLaneSz)
    leaf_chunk_lanes: int = 8  # lanes per leaf block (one block per walk step)
    # traversal worklist depth cap (kdtree.cpp:279).  The walks use
    # min(stack_depth, tree depth + 1) (ops.traverse._stack_depth); below
    # the tree depth the CPU's plain walk drops its deepest entry, as the
    # JAX kernels do, but the CUDA packet walk raises ValueError (a warp's
    # shared stack may not lose a node some lane still needs)
    stack_depth: int = 64
    use_kdtree: bool = True
    # brute-force closest hit (no kd tree, or <= brute_threshold triangles):
    # 'jnp' plain torch, 'pallas' the Möller–Trumbore kernel (ops.mt),
    # 'plucker' the Plücker kernel (ops.plucker); the kd walk ignores it
    triangle_backend: str = "jnp"
    # kd traversal backend (ops.traverse._backend), resolved as the JAX
    # package resolves it: 'auto' and 'packet' -> the packet kernel;
    # 'mega' -> the mega kernel, or the binned walk (block-loop kernel,
    # ops.binned) on a tree of more than 1024 nodes; 'forest' -> the
    # forest kernel on a tree with treelet tables, else as 'mega';
    # 'binned'; 'xla' -> the gather walk in torch.  Each wrapper takes its
    # plain version on CPU tensors.
    traversal_backend: str = "auto"
    treelet_cap: int = 0  # forest treelet node cap (0 = accel._kdtree_np.MAX_NODES)
    forest_tile: int = 0  # JAX TPU forest kernel's ray tile; no effect here
    # JAX TPU packet kernel's ray tile; no effect here: the port's packet
    # is one warp of 32 consecutive rays (ops/packet.py)
    packet_tile: int = 0
    fold_groups: int = 8  # JAX packet kernel only
    dma_fifo: int = 0  # JAX packet kernel only
    # bounce-sort key variant: killed rays sort to the tail (render._bounce_perm)
    sort_kill_tail: bool = False
    # frame rays in 8x128 screen-block order; auto-disabled when W/H
    # don't divide (an exact permutation of the wavefront)
    block_ray_order: bool = True
    # re-sort the wavefront every bounce by render._sort_keys (an exact
    # permutation: the frame's bits do not change) so that the warp
    # walks' warps hold neighbouring rays.  None = auto, the port's own
    # rule (render._sort_bounces): on where the descend is the packet or
    # the forest walk on CUDA tensors (not for the mega or binned
    # backends, nor brute force), off on the CPU.  Each CUDA default is
    # the faster side of that backend's frame timed sorted and unsorted in
    # turns on the H100 (chip_smoke.py phases 7, 11 and 12, PERF.md §6).
    # The JAX package sorts on its accelerator for every backend.
    sort_bounces: Optional[bool] = None
    # recompute each bounce in the backward (torch.utils.checkpoint), its
    # traversal outputs read back, not recomputed (render.render_rays)
    remat_bounces: bool = False
    # skip every bounce after the wavefront's last ray has terminated (an
    # exact identity, render.render_rays); off by default, as in the JAX package
    bounce_skip: bool = False
    # one flattened (L*N,) any-hit walk for the whole shadow pass instead
    # of L sequential N-ray walks — identical visibility bits.  None =
    # auto: on for CUDA tensors, off on the CPU (as the JAX package's
    # CPU default, which the CPU tests compare against).
    shadow_batch_lights: Optional[bool] = None
    # sort each light's batched shadow rays by hit-point Morton code (an
    # exact permutation; acts only with shadow_batch_lights).  None = the
    # JAX package's rule on every device: on over trees of 1,024 or more
    # leaf blocks (shading._sort_shadow; the flagship dragon, not the
    # teapot).  On the H100 the flagship frame is slower with it off
    # (chip_smoke.py phase 11, PERF.md §6).
    sort_shadow: Optional[bool] = None
    # triangle shadow rays cast from the light toward the surface
    # (shading.light_visibility, batched shadows only); f32 may flip a
    # grazing occluder, so None and False mean off on every device (the
    # JAX package turns it on only on its TPU)
    shadow_reverse: Optional[bool] = None
    # small-mesh crossover: meshes with <= this many triangles bypass the
    # kd walk for the brute-force intersector (0 = always use the tree)
    brute_threshold: int = 0
    # leaf sharding: the mesh axis whose ranks each hold one shard of the
    # triangles and kd tree (parallel.leaf_shard); set, the triangle
    # queries always take the sharded kd path (brute_threshold ignored)
    # and the scene must carry that axis's process group
    tri_shard_axis: str = ""
    replicate_reference_bugs: bool = False  # e.g. cylinder hit color dropped
    # bounce-sort key variant: direction bin in the high bits, origin
    # Morton code low (default: origin-major, render._bounce_perm)
    sort_dir_major: bool = False

    @property
    def Ratio(self) -> float:
        # src/utils/config.h:8 — recomputed from W/H, not independently loadable.
        return float(self.Width) / float(self.Height)

    @classmethod
    def load(cls, path: Optional[str] = None, **overrides) -> "Config":
        """Build a Config from an ini file plus keyword overrides.

        Mirrors ``Config::Load`` (``config.h:16-37``): unknown keys in the
        file are ignored with defaults retained; the file may set any subset.
        """
        cfg = cls()
        if path is not None:
            for key, value in _parse_ini(path).items():
                if not hasattr(cfg, key):
                    continue
                field_type = type(getattr(cfg, key))
                if field_type is bool:
                    setattr(cfg, key, value.strip().lower() in ("1", "true", "yes"))
                else:
                    setattr(cfg, key, field_type(value))
        for key, value in overrides.items():
            if not hasattr(cfg, key):
                raise KeyError(f"unknown config key: {key}")
            setattr(cfg, key, value)
        return cfg


def _parse_ini(path: str) -> dict:
    """Parse the reference's ``Key: Value`` format (config_loader.h:26-56).

    Lines without a colon are skipped; whitespace around key and value is
    stripped; later duplicates win.
    """
    out = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if key:
                out[key] = value
    return out
