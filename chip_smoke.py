#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``dod_raytracer_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed with its elapsed seconds as it ends:
  1. the card (nvidia-smi name and power limit) and the torch version;
  2. build of the CUDA kernels from csrc/ with plain nvcc, one process per
     source, all at once: packet_traverse.cu (the packet walk and the
     per-ray walk it replaced), kd_walk.cu (the mega and forest warp walks
     and the per-ray walks they replaced; all three warp walks are one
     template, kd_warp.cuh; both sources' whole -Xptxas -v is printed),
     block_loop.cu (the binned walk's leaf stage, and the per-ray
     kernel it replaced), binned_descend.cu (the binned walk's descend round),
     mt_closest.cu and plucker_closest.cu (brute force, one split-kernel
     template, brute.cuh, and the per-ray kernels they replaced; both
     sources' whole -Xptxas -v is printed), families_any.cu (the shadow
     rays' sphere, plane and cylinder any-hit) and families_closest.cu
     (their closest hit; each with its whole -Xptxas -v);
 2b. the host runtime: both native libraries (native/kdtree_build.cpp,
     native/objloader.cpp) built with g++ (the phase fails if either does
     not build: no fallback here); the dragon's SAH tree at config.ini's
     MaxPrims=8 and at the flagship's MaxPrims=192 by the native builder and
     by the numpy builder, in turns (native, numpy, native), every
     array of the two trees bit-equal, and each build's seconds; teapot.obj
     parsed by both parsers in turns, the vertex coordinates whose bits
     differ counted; the ``host_runtime`` line;
  3. the reference scene from config.ini (1920x1080): 16 spheres, 6 walls,
     the cylinder, the teapot (6,320 triangles), 9 lights, 10 bounces, with
     the kd-tree shape MaxPrims=96, leaf_chunk_lanes=48;
  4. one warm and one timed 1920x1080 frame through ``render_image``
     (backend 'auto': the packet walk, with the default sorts); every
     launch count is set to 0 just before the timed frame and read just
     after; the image must be finite, of the right shape and not black;
     then the same frame through the per-ray walk (the same sorts) and
     with sort_bounces flipped, each timed once and held to the first
     (u8 channels off by > 1), and 3 frames each with sort_bounces on and
     off, in turns; a 64x32 frame on the card must match the CPU path;
  5. parity of the packet walk and the per-ray walk it replaced, the mega
     warp walk and its per-ray walk, and the binned walk against the plain
     walk and brute force, on the triangle queries at bounce 0 and a later
     bounce of the ray tile whose primary rays hit the teapot most, and on
     the shadow rays of those bounces; the mega walks and the binned walk
     also against the per-ray packet walk, the mega warp walk against the
     packet walk on the same tree; the families' any-hit kernel against its
     plain version on the card, bit for bit, on every shadow wavefront
     these parity walks hand it (here and in phases 14, 23 and 25);
  6. the packet and mega warp walks' time per launch at the main path's
     shapes, each in turns with the per-ray walk it replaced, the plain
     walk's time on the same inputs, and the least time the card could
     take (see ``kernel_entry`` and ``work_bound``: the bytes these inputs
     make the kernel read over 3.35 TB/s, or the fp32 operations of its
     leaf tests over 67 TFLOP/s, whichever is larger); the families'
     any-hit kernel at the benchmark frame's shape (the 9,331,200 shadow
     lanes of bounce 0 of a 1,036,800-ray tile) in turns with its plain
     version, its launches in phase 4's frame and its bound (29 bytes a
     lane over 3.35 TB/s, or its operations with no early exit over 67
     TFLOP/s, whichever is larger: ``families_entry``); then all four walks
     per bounce over every traversal launch of one tile's render, with the
     bounce sort on and off (``per_bounce``);
 6b. the families' closest-hit kernel (``families_closest_phase``) on
     bounce 0 of a 1,036,800-ray tile: bit for bit its plain version's, and
     its time (CUDA events, 20 after 2 warm) in turns with the plain
     version's, against 60 bytes a ray over 3.35 TB/s; the benchmark's
     two-tile 10-bounce frame traced (record_shapes, the tracer on): one
     launch a call of the door, no op inside ``hit.families`` on a tensor
     other than (N,), (N, 1) or (N, 3), the frame bit-equal to the plain version's; a
     480x270 remat step of sphere colours and one of sphere centres (the
     colour path; the recompute path, its rows counted), traced the same way;
  7. the teapot frame with traversal_backend='mega' (the mega warp walk),
     one warm and one timed, against the per-ray frame of phase 4: u8
     channels off by > 1; then 3 frames each with sort_bounces on and off,
     in turns;
  8. the teapot frame with traversal_backend='binned' (the round kernel
     and the block-loop kernel, each launched once a round), not cut,
     timed once, against the per-ray frame of phase 4: no u8 channel may
     be off by > 1; then, on phase 5's bounce-0 queries, the binned walk
     with its rounds on the card against host-driven rounds
     (``tile_walks``), the block-loop kernel's time per launch in turns
     with the per-ray kernel it replaced, its plain version's, its bound
     (also with the whole batch's key reads and t, prim writes) and the
     distinct keys per warp and per CTA over
     the walk's launches (``block_loop_entry``), and the round kernel's
     time per launch, plain time and bound (``descend_entry``);
  9. brute force: the Möller–Trumbore and Plücker kernels on the
     2,073,600 primary rays of the 1080p teapot frame against its 6,320
     triangles and at the 480x270 frame's launch shape (16,384 rays), each
     held to its plain version and to the per-ray kernel it replaced bit
     for bit (the Plücker kernel also to brute force) and timed in turns
     with that kernel (new, per-ray, per-ray, new), beside its plain time
     and bound; at the launch shape the split count the rule picks, the
     CTAs, the time at other split counts, and the stats build's exit
     counts at both shapes; the cross-split tie case (the teapot twice,
     the copy 6,400 triangles on) bit for bit at 2, 4 and the rule's
     splits; and an fp32 torch.matmul of the Plücker product beside them;
     then the teapot frame at 480x270 with brute_threshold=6320 through
     triangle_backend 'jnp', 'pallas' (the Möller–Trumbore kernel) and
     'plucker' (the Plücker kernel), with the kernels' share of each
     frame (launches x ms per launch over the frame's seconds), and
     through the packet walk and the per-ray walk, in turns (packet,
     per-ray, per-ray, packet);
 10. the flagship scene of bench.py: the procedural dragon (869,952
     triangles) at 1920x1080, MaxPrims=192, leaf_chunk_lanes=48, seed 0,
     built on the card; its load and build times and tree shape;
 11. the flagship frame (backend 'auto': the packet walk; sort_shadow on
     by the automatic rule), one warm and one timed frame, with the counts
     set to 0 around the timed one; then, each timed once and held to it,
     the same frame through the per-ray walk, with sort_shadow off, and
     with sort_bounces flipped, and 3 frames each with sort_bounces on and
     off, in turns;
 12. the same frame with traversal_backend='forest' (the forest warp
     walk), one warm and one timed, against the per-ray frame of phase 11;
     then 3 frames each with sort_bounces on and off, in turns;
 13. the same frame with traversal_backend='mega', which resolves to the
     binned walk on this tree of 2,645 nodes (the resolution is printed),
     the full frame, timed once, against the per-ray frame of phase 11: no
     u8 channel may be off by > 1; if it took under BINNED_SORT_LIMIT
     seconds, both binned frames 3 times each with sort_bounces on and off,
     in turns;
 14. parity of the packet walk and its per-ray walk, the forest warp walk
     and its per-ray walk, and the binned walk against the plain forest
     walk, the plain walk and brute force on 65,536 rays of the dragon tile
     with the most bounce-0 dragon hits, at bounce 0 and bounce 3 and on
     their shadow rays; of the forest walks and the binned walk against
     the per-ray packet walk, and of the forest warp walk against the
     packet walk on the same tree.
     Closest-hit
     brute force is the Möller–Trumbore kernel, held first to the torch
     brute force on 4,096 of the rays and, at bounce 0, timed once against
     the per-ray kernel it replaced and once at each of several split
     counts (equal bits); any-hit brute force is torch on the shadow rays
     of 4,096 points;
 15. the packet and forest warp walks' times, plain times and bounds at
     the flagship's shapes (262,144 closest-hit and 2,359,296 any-hit rays
     of one tile), each in turns with the per-ray walk it replaced, and
     all four walks per bounce with the bounce sort on and off (as phase
     6); the tile's binned walk, device rounds against host-driven rounds,
     and the block-loop and round kernels' entries over its launches (as
     phase 8);
 16. one profiled flagship frame: device time by kernel, the traversal
     kernels' share of it, and the device's idle share, as one ``profile``
     line;
 17. the dragon vertex-gradient frame of ``bench.py --grad``: the flagship
     frame at 1920x1080 with remat_bounces, each 262,144-ray tile giving
     sum(render_rays(...) ** 2) (its padding rays left out) and the
     vertex grads accumulating over the tiles; one warm and one timed
     frame: its seconds, its ratio to phase 11's forward frame, its peak
     allocated memory, and the launches of every kernel in the forward
     and in the backward (the backward must launch none); then one tile
     with remat_bounces on and off (values to rtol 1e-5, grads by
     tests/test_grad.py:168-205's rule) and the peak memory of each, and
     one tile's backward profiled (device time by kernel, idle share);
 18. the card against the CPU: loss_and_param_grads for spheres, lights
     and triangles on the teapot at 64x32 with 3 bounces (the frames
     within the golden tolerance, the loss to CARD_CPU_LOSS_RTOL, each
     leaf's grads to a relative L1 distance under CARD_CPU_L1, and in
     the vertex and normal leaves at most CARD_CPU_SHARE of elements off
     by more than rtol 1e-3: the card's torch ops round otherwise than the
     CPU's, a borderline hit can flip over the mirror bounces, and its
     gathers' backward accumulates with atomics); on the same frame
     the vertex grads through the Möller–Trumbore and Plücker kernels
     (brute_threshold=6320) against the kd path's, to rtol 1e-4 (atol
     1e-7, tests/test_grad.py:95-122) but for the elements that the
     two inside tests allow (BRUTE_KD_EDGE_SHARE of the rays, each
     reaching at most one triangle a bounce on either path: the
     barycentric brute force and the kd walks' edge signs may pick
     different triangles of a shared edge);
     each kernel launched in the forward and none in the backward;
 19. the teapot fit of BASELINE config 3: ``train.fit`` at 1024x1024 with
     remat_bounces, FIT_STEPS Adam steps of FIT_PARAMS from colors and
     intensities perturbed from FIT_SEED towards the unperturbed frame:
     seconds a step, and the loss must fall; then one ``sgd_step`` of the
     dragon's vertices along phase 17's grads (no coordinate moves more
     than SGD_MAX_STEP): the kd blocks of the tree it returns (kept, or
     rebuilt where a triangle left its lane's filing box) must equal
     ``refresh_kd_blocks`` of the new vertices, and the next flagship
     frame must be finite; the
     ``grad`` line;
 20. the CLI, ``python -m dod_raytracer_tpu_torch.cli`` in a subprocess:
     the teapot frame of config.ini alone (its own kd shape, MaxPrims=8,
     leaf_chunk_lanes=8, ray_tile=32768), its PNG read back by
     ``io.read_png`` and held to phase 4's frame (u8 channels off by > 1
     under 1%); the same scene at CLI_PROFILE_SIZE with ``--profile``, its
     trace naming scene_build, render, png_write and the packet kernel; then the flagship dragon from a written ini, held to
     phase 11's frame; then the dragon with config.ini alone (MaxPrims=8,
     the shape a user of ``--mesh dragon`` gets), held to phase 11's
     frame; each run's scene build seconds, its kd tree built by the native
     builder; the ``cli`` line;
 20b. ``examples/inverse_rendering_torch.py`` at its 96x64, 3 bounces, 60
     Adam steps: its three PNGs, the loss must fall, the albedo and
     intensity errors printed; the ``inverse_rendering_example`` line;
 21. ``checkpoint.TiledRenderJob`` on the flagship scene, 8 tiles of
     262,144 rays: owner 0 of 2 must leave tiles 0, 2, 4, 6 and no frame;
     the resume with one owner must launch exactly 4 x 10 closest-hit and
     4 x 10 any-hit packet walks, and its frame is held to phase 11's; the
     ``tiled_job`` line (both passes' seconds, the .npy writes' seconds);
 22. ``bounce_skip``: the open scene of tests/test_render_golden.py:82-101
     (teapot, one sphere, one light, no walls) at 1920x1080 with the knob
     off and on, bit-equal, fewer launches with it on, KNOB_REPS frames
     each with it on and off, in turns, the bounces skipped per tile; phase 4's frame with it on, bit-equal to phase 4's, then
     KNOB_REPS frames each with it on and off, in turns; the
     ``bounce_skip`` line;
 23. reversed shadow rays (``shadow_reverse``): on the flagship tile of
     phase 15 at bounce 0 and bounce 3, the reversed triangle rays
     (``shading.reversed_rays``) through the packet any-hit walk against
     the plain walk on the first SHADOW_POINTS points per light (bits
     equal) and against the torch brute force on DRAGON_BRUTE_RAYS points
     per light (its differing rays against the edge-sign brute force),
     timed in turns with the forward rays of
     the same points, each beside its ``work_bound``; then the teapot and
     flagship frames with shadow_reverse=True (the dragon sorted by
     direction bin), each against its forward frame: under 2% of pixels
     whose largest channel differs by more than 1e-3
     (tests/test_render_golden.py:199-215) and u8 channels off by > 1
     under 1%, then KNOB_REPS frames each reversed and forward, in turns;
     the ``shadow_reverse`` line;
 24. distribution (``parallel``), every frame the flagship's and held to
     phase 11's (shape, u8 channels off by > 1 under 1%), each world's
     ranks started by ``multihost.spawn`` after phase 2 built the kernels
     (a rank that fails or outlasts DIST_TIMEOUT_S fails the run), each
     rank's launch counts set to 0 just before its timed frame and read
     just after (only the packet walk, in both modes): the dp render
     (``render_image_sharded``) in an NCCL world of one rank a card (this
     process on a one-card machine), then in a gloo world of DP_WORLD
     processes sharing the card (the backend rule: more ranks than cards);
     seconds, launches a rank;
 25. the leaf-sharded render (``render_image_leaf_sharded``,
     ``tri_shard_axis="mp"``, the default sorts on) in gloo worlds of
     (dp, mp) = LEAF_SHAPES on the card: each rank builds its shard's tree,
     renders a timed frame and one more with the combine's collectives
     counted (calls, bytes, seconds); then, in this process, the packet
     walk on shard 0 of 2's tree against its plain walk by the packet
     rule, on phase 14's window at bounce 0 and LATER_BOUNCE (closest hit
     and the first SHADOW_POINTS points' shadow rays);
 26. the train steps, run by phase 24's gloo world and phase 25's (1, 2)
     world after their frames: the 1D dp step (``make_train_step`` on
     DP_PARAMS, remat_bounces) twice, its first loss held to the
     single-process loss of phase 11's frame to rtol 1e-5; the 2D step
     (``loss_and_vertex_grads_2d``, then one ``make_train_step_2d`` step)
     on the dragon's vertices, its loss held to phase 17's to rtol 1e-5 and
     its vertex gradient, gathered here from the shards, to phase 17's by
     phase 18's rule; the ``distributed`` line (times from processes that
     share one card: they do not measure scaling); then the card line
     and the ``kernels`` JSON line (each path's kernels with their
     launches on the gradient path, forward and backward; the packet
     walk's dragon entries with their launches on phases 20-23's paths
     and each rank's on phases 24-26's, the any-hit one with the reversed
     rays' times and bounds);
 27. the result line ``{"ok": true, "device": {...}}``.

Parity rules.  Against the plain walks, and between the per-ray kernels
(the per-ray packet, mega and forest walks, the binned walk), the outputs
must be equal bit for bit: the plain walks compute the kernels' leaf test
(Plücker edge signs on block_g, then the Möller–Trumbore t on block_tris,
every operation in the kernels' order) and their visit order, so hit masks
are equal, and t and prims are equal wherever both hit.  The warp walks
(packet, mega, forest: one template over three node layouts) visit the
union of a warp's leaves in the warp's order, so they are held to the JAX
package's rule for its packet kernel (tests/test_packet.py), tightened
(``ops.packet.parity``): hit masks and any-hit bits equal, closest-hit t
bit-equal, and a prim may differ only where both triangles'
Möller–Trumbore t are bit-equal; such ties are counted, and whether every
bit is equal besides (``bits_equal``).  The binned walk's
any-hit t and prims must equal the plain walks' too (the same block-closest
leaf stage; the per-ray kernels stop at a block's first hit slot, so only
their any-hit bits are compared).  Brute force is a
different function, Möller–Trumbore with its barycentric test over every
triangle (after tests/test_packet.py): there a prim may differ at a tie
(both candidates' t agree to rtol 1e-5), and every ray whose hit mask or
prim differs goes through the edge-sign brute force (``ops/triangle.py``
``edge_sign_brute_closest`` / ``edge_sign_brute_any``: the kernels' own
leaf test, Plücker edge signs on the rows the kernels test, then the
Möller–Trumbore t, over every triangle), which the kernel must equal with
no edge excuse: hit masks and any-hit bits equal, t bit-equal, and a prim
may differ only where both triangles' Möller–Trumbore t are bit-equal.
The barycentric side is printed as the reference side: the rays that meet
the kernel's or the brute force's triangle within EDGE_EPS (barycentric)
of an edge (``at_edge``); away from an edge at most 0.001% of the rays may
differ in their hit mask from it, no prim may, and t agrees to rtol 1e-3
where both hit.  The Plücker kernel, whose t is num/den, is held to brute
force with ``tests/test_pallas.py``'s rule (hit masks and indices equal
where both hit, but for ties; t to rtol 1e-4), and its differing rays to
the edge-sign brute force on its own packed edge rows (hit masks equal, a
prim different only at bit-equal Möller–Trumbore t, t to rtol 1e-4).

Any failed check raises and the script exits non-zero without a result
line; so does a run without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # kernel -> (source in the repo, the TPU kernel it replaces)
    "packet_traverse": ("dod_raytracer_tpu_torch/csrc/packet_traverse.cu",
                        "dod_raytracer_tpu/ops/pallas/packet_kernel.py:498"),
    "mega_walk": ("dod_raytracer_tpu_torch/csrc/kd_walk.cu",
                  "dod_raytracer_tpu/ops/pallas/traverse_kernel.py:289"),
    "forest_walk": ("dod_raytracer_tpu_torch/csrc/kd_walk.cu",
                    "dod_raytracer_tpu/ops/pallas/forest_kernel.py:343"),
    "block_loop": ("dod_raytracer_tpu_torch/csrc/block_loop.cu",
                   "dod_raytracer_tpu/ops/pallas/block_loop_kernel.py:143"),
    # the binned walk's descend round: XLA's while_loop in the JAX package, no Pallas kernel
    "binned_descend": ("dod_raytracer_tpu_torch/csrc/binned_descend.cu",
                       "dod_raytracer_tpu/ops/traverse.py:350"),
    "mt_closest": ("dod_raytracer_tpu_torch/csrc/mt_closest.cu",
                   "dod_raytracer_tpu/ops/pallas/mt_kernel.py:118"),
    "plucker_closest": ("dod_raytracer_tpu_torch/csrc/plucker_closest.cu",
                        "dod_raytracer_tpu/ops/pallas/plucker_kernel.py:117"),
    # the shadow rays' sphere, plane and cylinder tests: XLA in the JAX package, no Pallas kernel
    "families_any": ("dod_raytracer_tpu_torch/csrc/families_any.cu", "dod_raytracer_tpu/intersect.py:123"),
    # the sphere, plane and cylinder closest hit: XLA in the JAX package (closest_hit's family chain)
    "families_closest": ("dod_raytracer_tpu_torch/csrc/families_closest.cu", "dod_raytracer_tpu/intersect.py:89"),
}
SOURCES = ["packet_traverse", "kd_walk", "block_loop", "binned_descend", "mt_closest", "plucker_closest",
           "families_any", "families_closest"]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
LATER_BOUNCE = 3
SHADOW_POINTS = 65536  # hit points per parity bounce whose shadow rays are checked
DRAGON_PARITY_RAYS = 65536  # rays of the dragon parity window
DRAGON_BRUTE_RAYS = 4096  # of those, the torch brute force's share over 869,952 triangles
# against brute force only (the plain walks and the kernels must agree bit for bit)
MASK_AGREEMENT = 0.99999  # hit masks, away from ties and edges
T_RTOL = 1e-3  # t where both hit (tests/test_packet.py)
TIE_RTOL = 1e-5  # a prim may differ at a tie (tests/test_packet.py:49-63)
EDGE_EPS = 1e-3  # barycentric distance from an edge under which a difference from brute force counts as at an edge
# phase 18 compares gradients through the brute-force path and the kd path: two inside tests
# (barycentric, edge signs) that may reach different triangles at a shared edge on at most this
# share of the rays (rounded up); each kernel is held to its own reference with no such excuse
BRUTE_KD_EDGE_SHARE = 1e-3
RAY_CHUNK = 32768  # rays per torch brute-force call (bounds its (rays, 2048, 3) temporaries)
PLUCKER_T_RTOL = 1e-4  # the Plücker kernel's t against brute force (tests/test_pallas.py)
BRUTE_PARITY_RAYS = 65536  # of the 1080p primary rays, held to the plain versions and brute force
BRUTE_FRAME = dict(Width=480, Height=270, ray_tile=16384, brute_threshold=6320)  # phase 9
BINNED_SORT_LIMIT = 20.0  # seconds: a dragon binned frame under this is timed with sort_bounces on and off
MT_OPS = 46  # fp32 operations per ray-triangle pair, mt_closest.cu (27 mul, 18 add, 1 rcp)
PLUCKER_OPS = 46  # plucker_closest.cu (25 mul, 20 add, 1 div)
# fp32 operations of families_any.cu's tests with no early exit: a sphere 19 (15, and 4 more past the
# closest-approach test), a plane 14, a cylinder 113 (body 67, each cap 23)
FAMILY_OPS = {"sphere": 19, "plane": 14, "cylinder": 113}
FAMILY_LANE_BYTES = 29  # o, d, t_max read (28 B), one bool written
FAMILY_TILE = 1036800  # the benchmark frame's ray tile (gpubench/configs/teapot-ref.json)
FAMILY_RAY_BYTES = 60  # families_closest.cu: o, d, t_max read (28 B); t, normal, colour, winner written (32 B)
CLOSEST_GRAD_FRAME = dict(Width=480, Height=270, ray_tile=0, remat_bounces=True)  # phase 6b's gradient steps
U8_TOLERANCE = 0.01  # golden tolerance: fraction of u8 channels off by > 1
TIMING_REPS = 20  # CUDA-event launches per timing, after 2 warm
BOUNCE_REPS = 2  # the same, per bounce of a tile's render, after 1 warm
SORT_REPS = 3  # frames each with sort_bounces on and off, in turns
CLI_PROFILE_SIZE = (320, 180)  # phase 20's frame under --profile
KNOB_REPS = 2  # frames each with bounce_skip, shadow_reverse on and off, in turns (phases 22, 23)
# card against CPU grads (phase 18).  Their frames differ in rounding (CUDA's and the CPU's torch
# ops), and at 3 mirror bounces a borderline hit can flip: one pixel of the 64x32 frame on an H100
# (PERF.md §6), which moved the loss by 3.4e-4 and the sphere grads by up to 0.2% (L1).
# So: the frames within the golden tolerance, the loss to this rtol, each leaf's grads to this
# relative L1 distance, and in leaves of at least CARD_CPU_ELEMENTS elements (vertices, normals) at
# most CARD_CPU_SHARE of elements off by more than rtol 1e-3 (atol 1e-6 of the leaf's largest grad)
CARD_CPU_LOSS_RTOL = 1e-3
CARD_CPU_L1 = 1e-2
CARD_CPU_ELEMENTS = 1000
CARD_CPU_SHARE = 1e-3
FIT_PARAMS = ("spheres.color", "mesh_colors", "lights.intensity")  # phase 19, BASELINE config 3
FIT_STEPS = 5
FIT_SEED = 0  # the start's colors and intensities: the truth's times U(0.7, 1.3) from this seed
SGD_MAX_STEP = 1e-4  # the dragon's sgd_step moves no vertex coordinate further than this
FLAGSHIP = dict(Width=1920, Height=1080, use_kdtree=True, ray_tile=0, MaxPrims=192, leaf_chunk_lanes=48)
DP_WORLD = 2  # gloo ranks sharing the card in phases 24 and 26
LEAF_SHAPES = ((1, 2), (2, 2))  # (dp, mp) gloo worlds sharing the card in phase 25
DP_PARAMS = ("spheres", "lights")  # phase 26's 1D step
DP_TARGET = 0.25  # its target colour (tests/test_sharding.py)
DIST_TIMEOUT_S = 600.0  # a spawned world of phases 24-26 that runs longer fails the run
# the numpy builder's scene build of the CLI dragon with config.ini alone (MaxPrims=8) on the host of an
# H100 machine (scripts/torch_build_time.py --mesh dragon; PERF.md §6), printed beside phase 20's
NUMPY_DRAGON_INI_BUILD_S = 10.19

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(torch, fn):
    """(seconds, result) of one call, host clock, synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def time_turns(torch, fns: dict, reps: int, warm: int = 2) -> dict:
    """Mean ms per call of each of ``fns``, timed in turns there and back
    (a, b, ..., b, a) on the same card, each turn ``time_ms``."""
    names = list(fns)
    ms = {k: 0.0 for k in names}
    for k in names + names[::-1]:
        ms[k] += time_ms(torch, fns[k], reps, warm) / 2
    return ms


def u8_off(quantize_u8, a, b) -> float:
    """Fraction of u8 channels of two frames that differ by more than 1."""
    diff = quantize_u8(a).astype(int) - quantize_u8(b).astype(int)
    return float((abs(diff) > 1).mean())


def device_ms(torch, prof) -> dict:
    """Device milliseconds by kernel name of a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op records repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def add_counts(total: dict, counts: dict) -> dict:
    """total += counts, kernel by kernel and mode by mode."""
    for k, modes in counts.items():
        for m, n in modes.items():
            total.setdefault(k, {}).setdefault(m, 0)
            total[k][m] += n
    return total


def launched(counts: dict) -> dict:
    """The kernels and modes of ``counts`` that launched at least once."""
    return {k: {m: n for m, n in modes.items() if n} for k, modes in counts.items() if any(modes.values())}


def kernel_counters() -> dict:
    """Kernel name -> the object whose ``launches`` counts it and whose
    ``reset_launches()`` sets the counts to 0: every kernel of the port,
    the per-ray kernels the warp walks and brute-force kernels replaced,
    and the binned walk's round kernel."""
    from dod_raytracer_tpu_torch.ops import binned, forest, mega, mt, packet, plucker

    counters = {"packet_traverse": packet, "mega_walk": mega, "forest_walk": forest, "block_loop": binned,
                "mt_closest": mt, "plucker_closest": plucker}  # kernel -> the module that counts it
    for name, module in list(counters.items()):
        counters[f"{name}_per_ray"] = SimpleNamespace(launches=module.per_ray_launches,
                                                      reset_launches=module.reset_launches)
    counters["binned_descend"] = SimpleNamespace(launches=binned.descend_launches,
                                                 reset_launches=binned.reset_launches)
    return counters


def reset_launches(counters: dict) -> None:
    for module in counters.values():
        module.reset_launches()


def read_launches(counters: dict) -> dict:
    return {k: dict(module.launches) for k, module in counters.items()}


def grad_close(g_ref, g, rtol: float, atol: float) -> dict:
    """tests/test_grad.py:168-205's comparison of two gradients: the share
    of elements not close (rtol, atol) and the relative L1 distance."""
    import torch

    close = torch.isclose(g, g_ref, rtol=rtol, atol=atol)
    return {"elements": g.numel(), "off": int((~close).sum()), "share_off": float((~close).float().mean()),
            "rel_l1": float((g - g_ref).abs().sum() / g_ref.abs().sum().clamp_min(1e-30)),
            "max_abs_ref": float(g_ref.abs().max())}


def grad_phases(torch, dev, dscene, fcfg, flag_s: float, reset_counts, read_counts) -> dict:
    """Phases 17-19, the gradient path, -> their numbers (see the module
    docstring).  Any failed check raises."""
    from dod_raytracer_tpu_torch import Config, default_scene, render_image
    from dod_raytracer_tpu_torch.accel.kdtree import refresh_kd_blocks
    from dod_raytracer_tpu_torch.grad import loss_and_param_grads, merge_params, mse_loss, render_for_grad, sgd_step
    from dod_raytracer_tpu_torch.render import frame_rays, render_rays
    from dod_raytracer_tpu_torch.train import fit

    import numpy as np

    out = {}

    # ---- 17. the dragon vertex-gradient frame (bench.py --grad) ----
    gcfg = dataclasses.replace(fcfg, remat_bounces=True)
    o_f, d_f, raw_f, n_f, gtile = frame_rays(gcfg, dev)

    def tile_loss(verts, start, cfg):
        """sum(render_rays(...) ** 2) of the tile at ``start``, its padding
        rays left out, with the vertices ``verts``."""
        s = dataclasses.replace(dscene, triangles=dataclasses.replace(dscene.triangles, verts=verts))
        sl = slice(start, start + gtile)
        return torch.sum(render_rays(s, o_f[sl], d_f[sl], raw_f[sl], cfg)[:n_f - start] ** 2)

    def grad_frame():
        """-> (loss, verts.grad accumulated over the tiles, forward counts,
        backward counts)."""
        verts = dscene.triangles.verts.detach().clone().requires_grad_(True)
        total, fwd, bwd = 0.0, {}, {}
        for start in range(0, o_f.shape[0], gtile):
            reset_counts()
            val = tile_loss(verts, start, gcfg)
            add_counts(fwd, read_counts())
            reset_counts()
            val.backward()
            add_counts(bwd, read_counts())
            total += float(val.detach())
        return total, verts.grad, fwd, bwd

    wall_s(torch, grad_frame)
    torch.cuda.reset_peak_memory_stats()
    gsec, (gloss, gverts, gfwd, gbwd) = wall_s(torch, grad_frame)
    gpeak = torch.cuda.max_memory_allocated()
    check(all(gfwd["packet_traverse"][m] > 0 for m in ("closest", "any_hit")),
          f"grad frame: the packet walk did not launch in the forward: {gfwd}")
    check(not launched(gbwd), f"grad frame: kernels launched in the backward: {launched(gbwd)}")
    check(math.isfinite(gloss) and bool(torch.isfinite(gverts).all()), "grad frame: non-finite loss or grads")
    check(float(gverts.abs().max()) > 0, "grad frame: the vertex grads are all zero")
    out["grad_frame"] = dict(seconds=gsec, fwd_frame_seconds=flag_s, ratio_to_forward=gsec / flag_s,
                             peak_bytes=gpeak, tile=gtile, tiles=o_f.shape[0] // gtile, loss=gloss,
                             launches_forward=launched(gfwd), launches_backward=launched(gbwd))
    log(f"phase 17 dragon vertex-gradient frame (1920x1080, remat_bounces, {gtile}-ray tiles): fwd+bwd "
        f"{gsec:.3f} s after one warm frame, {gsec / flag_s:.3f} x phase 11's forward frame ({flag_s:.3f} s), "
        f"peak {gpeak / 2**30:.2f} GiB allocated; launches in the forward {json.dumps(launched(gfwd))}, "
        f"in the backward {json.dumps(launched(gbwd))}; loss {gloss:.6e}, max |grad| "
        f"{float(gverts.abs().max()):.4g}")

    # one tile with remat_bounces on and off
    tile = {}
    for remat in (True, False):
        verts = dscene.triangles.verts.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sec, val = wall_s(torch, lambda: tile_loss(verts, 0, dataclasses.replace(gcfg, remat_bounces=remat)))
        bsec = wall_s(torch, val.backward)[0]
        tile[remat] = dict(value=float(val.detach()), grad=verts.grad, fwd_s=sec, bwd_s=bsec,
                           peak_bytes=torch.cuda.max_memory_allocated() - base)
        del val, verts
    vals = (tile[True]["value"], tile[False]["value"])
    check(math.isclose(*vals, rel_tol=1e-5), f"one tile: remat on and off give {vals}")
    rule = grad_close(tile[False]["grad"], tile[True]["grad"], rtol=1e-4, atol=1e-6)
    check(rule["share_off"] < 1e-3 and rule["rel_l1"] < 1e-3,
          f"one tile: vertex grads with remat on and off differ: {rule}")
    out["remat_tile"] = {("on" if r else "off"): {k: v for k, v in t.items() if k != "grad"} for r, t in tile.items()}
    out["remat_tile"]["grads"] = rule
    del tile
    log(f"phase 17 one tile ({gtile} rays) with remat_bounces on and off: {json.dumps(out['remat_tile'])}")

    # where one tile's backward spends its device time
    from torch.profiler import ProfilerActivity, profile

    verts = dscene.triangles.verts.detach().clone().requires_grad_(True)
    val = tile_loss(verts, 0, gcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bwd_ms = wall_s(torch, val.backward)[0] * 1e3
    by_name = device_ms(torch, prof)
    busy = sum(by_name.values())
    out["backward_profile"] = dict(wall_ms=bwd_ms, device_busy_ms=busy,
                                   device_idle_share=max(0.0, 1.0 - busy / bwd_ms) if busy else None,
                                   top=[{"name": k[:90], "ms": v} for k, v in
                                        sorted(by_name.items(), key=lambda kv: -kv[1])[:10]])
    del val, verts
    log(f"phase 17 one tile's backward (remat_bounces), profiled: {json.dumps(out['backward_profile'])}")

    # ---- 18. the card against the CPU ----
    small = Config.load(os.path.join(ROOT, "config.ini"), Width=64, Height=32, MaxPrims=96, leaf_chunk_lanes=48,
                        recursion_depth=3)
    params = ("spheres", "lights", "triangles")
    cscene = default_scene(seed=0, cfg=small, mesh="teapot").build(small, device="cpu")
    with torch.no_grad():
        target = render_for_grad(cscene, small) * 0.8 + 0.02
    gscene = default_scene(seed=0, cfg=small, mesh="teapot").build(small, device=dev)
    with torch.no_grad():
        far = float(((render_for_grad(gscene, small).cpu() - render_for_grad(cscene, small)).abs() > 2e-3)
                    .float().mean())
    check(far < U8_TOLERANCE, f"card vs CPU 64x32 frame: {far:.4%} of channels off by > 2e-3")
    cpu_loss, cpu_grads = loss_and_param_grads(cscene, target, small, params)
    reset_counts()
    card_loss, card_grads = loss_and_param_grads(gscene, target.to(dev), small, params)
    card_counts = launched(read_counts())
    check(set(card_counts) == {"packet_traverse"}, f"card grads: launches {card_counts}")
    check(math.isclose(float(card_loss), float(cpu_loss), rel_tol=CARD_CPU_LOSS_RTOL),
          f"card loss {float(card_loss)} vs CPU {float(cpu_loss)}")
    vs_cpu = {}
    for fam in params:
        for f in dataclasses.fields(cpu_grads[fam]):
            g_cpu = getattr(cpu_grads[fam], f.name)
            if g_cpu is None:
                continue
            g = getattr(card_grads[fam], f.name).cpu()
            check(bool(torch.isfinite(g).all()), f"card grads {fam}.{f.name} are not finite")
            res = grad_close(g_cpu, g, rtol=1e-3, atol=1e-6 * float(g_cpu.abs().max()))
            vs_cpu[f"{fam}.{f.name}"] = res
            check(res["rel_l1"] < CARD_CPU_L1 and (g.numel() < CARD_CPU_ELEMENTS or res["share_off"] <= CARD_CPU_SHARE),
                  f"card grads {fam}.{f.name} vs CPU: {res}")
    out["card_vs_cpu"] = dict(loss=[float(card_loss), float(cpu_loss)], frame_channels_off=far, grads=vs_cpu,
                              launches=card_counts)
    log(f"phase 18 teapot 64x32, 3 bounces: {far:.4%} of the frame's channels off the CPU's by > 2e-3; loss on "
        f"the card {float(card_loss):.9e}, on the CPU {float(cpu_loss):.9e}; grads vs the CPU's "
        f"{json.dumps(vs_cpu)}; launches {json.dumps(card_counts)}")

    # the vertex grads through the brute-force kernels against the kd path's
    kd_verts = card_grads["triangles"].verts
    edge_elems = math.ceil(BRUTE_KD_EDGE_SHARE * small.Width * small.Height) * 2 * small.recursion_depth * 9
    out["brute_vs_kd"] = {}
    for backend, kernel in (("pallas", "mt_closest"), ("plucker", "plucker_closest")):
        bcfg_ = dataclasses.replace(small, brute_threshold=gscene.n_triangles, triangle_backend=backend)
        fwd, bwd = {}, {}
        dv = {"triangles.verts": gscene.triangles.verts.detach().clone().requires_grad_(True)}
        reset_counts()
        loss = mse_loss(merge_params(gscene, dv), target.to(dev), bcfg_)
        add_counts(fwd, read_counts())
        reset_counts()
        loss.backward()
        add_counts(bwd, read_counts())
        check(set(launched(fwd)) == {kernel}, f"{backend} grads: forward launches {launched(fwd)}")
        check(not launched(bwd), f"{backend} grads: backward launches {launched(bwd)}")
        res = grad_close(kd_verts, dv["triangles.verts"].grad, rtol=1e-4, atol=1e-7)
        check(res["off"] <= edge_elems, f"{backend} vertex grads vs the kd path's: {res} (at most {edge_elems} off)")
        out["brute_vs_kd"][kernel] = dict(res, launches_forward=fwd[kernel]["closest"],
                                          launches_backward=0, edge_elements_allowed=edge_elems)
    log(f"phase 18 vertex grads through the brute-force kernels vs the kd path's: {json.dumps(out['brute_vs_kd'])}")
    del cscene, gscene, cpu_grads, card_grads, kd_verts

    # ---- 19. the teapot fit (BASELINE config 3) ----
    tcfg = Config.load(os.path.join(ROOT, "config.ini"), Width=1024, Height=1024, MaxPrims=96,
                       leaf_chunk_lanes=48, remat_bounces=True)
    truth = default_scene(seed=0, cfg=tcfg, mesh="teapot").build(tcfg, device=dev)
    with torch.no_grad():
        target = render_for_grad(truth, tcfg)
    rng = np.random.default_rng(FIT_SEED)

    def perturb(x):
        return (x * torch.from_numpy(rng.uniform(0.7, 1.3, tuple(x.shape)).astype(np.float32)).to(dev))

    start = dataclasses.replace(
        truth, spheres=dataclasses.replace(truth.spheres, color=perturb(truth.spheres.color).clamp(0.0, 1.0)),
        mesh_colors=perturb(truth.mesh_colors).clamp(0.0, 1.0),
        lights=dataclasses.replace(truth.lights, intensity=perturb(truth.lights.intensity)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    fsec, (_, losses) = wall_s(torch, lambda: fit(start, target, tcfg, FIT_PARAMS, steps=FIT_STEPS, lr=0.05,
                                                  log_every=1))
    fit_counts = launched(read_counts())
    check(len(losses) == FIT_STEPS and all(math.isfinite(v) for v in losses), f"fit losses {losses}")
    check(losses[-1] < losses[0], f"fit: the loss did not fall from step 0 to step {FIT_STEPS - 1}: {losses}")
    out["fit"] = dict(seconds_per_step=fsec / FIT_STEPS, losses=losses, peak_bytes=torch.cuda.max_memory_allocated(),
                      launches=fit_counts)
    log(f"phase 19 teapot fit, 1024x1024, {FIT_STEPS} Adam steps of {FIT_PARAMS}: {fsec / FIT_STEPS:.3f} s a step, "
        f"losses {losses}, peak {out['fit']['peak_bytes'] / 2**30:.2f} GiB allocated, launches {json.dumps(fit_counts)}")
    del truth, start, target

    # one sgd_step of the dragon's vertices, then a frame
    lr = SGD_MAX_STEP / float(gverts.abs().max())
    moved = sgd_step(dscene, {"triangles.verts": gverts}, lr)
    ref = refresh_kd_blocks(moved.kd, moved.triangles.verts)
    check(not torch.equal(moved.triangles.verts, dscene.triangles.verts), "sgd_step did not move the vertices")
    check(not torch.equal(moved.kd.block_tris, dscene.kd.block_tris), "sgd_step did not refresh block_tris")
    for f in ("block_tris", "block_g", "block_aabb"):
        check(torch.equal(getattr(moved.kd, f), getattr(ref, f)), f"sgd_step: {f} differs from refresh_kd_blocks")
    msec, mimg = wall_s(torch, lambda: render_image(moved, fcfg, device=dev))
    check(tuple(mimg.shape) == (fcfg.Height, fcfg.Width, 3) and bool(torch.isfinite(mimg).all()),
          "the frame after sgd_step is not finite")
    out["sgd_step"] = dict(lr=lr, max_step=SGD_MAX_STEP, frame_seconds=msec)
    out["vertex_grads"] = gverts  # held by phase 26; not printed
    log(f"phase 19 dragon sgd_step on triangles.verts (lr {lr:.4g}: at most {SGD_MAX_STEP} a coordinate): "
        f"block_tris, block_g and block_aabb equal refresh_kd_blocks of the new vertices "
        f"({'rebuilt' if moved.kd.lane_lo is not dscene.kd.lane_lo else 'kept'} tree); the next frame "
        f"{msec:.3f} s, finite, mean {float(mimg.mean()):.4f}")
    return out


# ---- phases 24-26: the ranks of the distributed paths.  multihost.spawn runs each in a process of its
# own, which imports this file by name (its main() does not run there) and returns numpy results.

def wide_ops(torch, prof, span: str) -> list:
    """The ops of a ``record_shapes`` profile that ran inside a ``span``
    range on its thread and read a tensor other than (N,), (N, 1), (N, 3)
    or a scalar: [(op, shapes)]."""
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    # the host's ranges only: the profiler also keeps a device-side range of each span, which runs
    # behind the host and overlaps the ops the host enqueues meanwhile
    ranges = [(e.time_range.start, e.time_range.end, e.thread) for e in host if e.name == span]
    check(bool(ranges), f"the profile holds no {span} range")
    wide = []
    for e in host:
        if e.name == span:
            continue
        if not any(a <= e.time_range.start and e.time_range.end <= b and e.thread == th for a, b, th in ranges):
            continue
        shapes = [sh for sh in (e.input_shapes or []) if isinstance(sh, list)]
        if any(len(sh) > 2 or (len(sh) == 2 and sh[1] not in (1, 3)) for sh in shapes):
            wide.append((e.name, shapes))
    return wide


def kernel_count(torch, prof, name: str) -> int:
    """Launches of device kernels whose name holds ``name`` in a profile."""
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key)


def families_closest_phase(torch, dev, scene=None) -> dict:
    """Phase 6b: the families' closest-hit kernel (csrc/families_closest.cu)
    at the benchmark frame's shape, bounce 0 of a 1,036,800-ray teapot-ref
    tile: the plain version's bits, CUDA events (TIMING_REPS after 2 warm)
    in turns with the plain version, against its byte bound (60 B a ray);
    then the 10-bounce frame traced (the tracer on, ``record_shapes``):
    one launch a call (20), no op inside ``hit.families`` on an (N, S) or
    (N, S, 3) tensor, the frame bit-equal to the plain version's; then a
    480x270 remat step of sphere colours and one of sphere centres, traced
    the same way (the colour path and the recompute path, forward and
    backward) -> the ``kernels`` line's entry."""
    from dod_raytracer_tpu_torch import Config, default_scene, render_image
    from dod_raytracer_tpu_torch.grad import merge_params, mse_loss, render_for_grad
    from dod_raytracer_tpu_torch.ops import families
    from dod_raytracer_tpu_torch.render import frame_rays
    from dod_raytracer_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    cfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=FAMILY_TILE)
    if scene is None:
        scene = default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device=dev)
    eps, bug = cfg.Epsilon, cfg.replicate_reference_bugs
    o_all, d_all, _, _, tile = frame_rays(cfg, dev)
    o, d = o_all[:tile].contiguous(), d_all[:tile].contiguous()
    t_max = torch.full((tile,), float("inf"), device=dev)

    def parity(o, d, t_max, label):
        winner, got = families.closest_kernel(scene, o, d, t_max, eps, bug)
        ref_winner, ref = families.closest_plain(scene, o, d, t_max, eps, bug)
        hit = ref_winner >= 0
        differ = int(((winner != ref_winner) | (got.t != ref.t) | hit & ((got.normal != ref.normal).any(1)
                                                                         | (got.color != ref.color).any(1))).sum())
        check(differ == 0, f"families_closest {label}: {differ} of {o.shape[0]} rays differ from the plain version")
        check(not bool(got.normal[~hit].any() or got.color[~hit].any()), f"families_closest {label}: a miss not zero")
        return int(hit.sum())

    hits = parity(o, d, t_max, "bounce 0")
    turns = time_turns(torch, {"kernel": lambda: families.closest_kernel(scene, o, d, t_max, eps, bug),
                               "plain": lambda: families.closest_plain(scene, o, d, t_max, eps, bug)}, TIMING_REPS)
    n_cyl = min(scene.n_cylinders, scene.cylinders.base.shape[0])
    ops = tile * (scene.spheres.center.shape[0] * FAMILY_OPS["sphere"]
                  + scene.planes.point.shape[0] * FAMILY_OPS["plane"] + n_cyl * FAMILY_OPS["cylinder"])
    nbytes = tile * FAMILY_RAY_BYTES
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    log(f"phase 6b families_closest[closest]: {tile} rays ({hits} hit), kernel {turns['kernel']:.4f} ms/launch, "
        f"plain {turns['plain']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {ops} operations), "
        f"{turns['kernel'] / bound_ms:.2f}x the bound")

    door = families.closest
    seen = {"calls": 0, "rays": 0}

    def counting(scene, o, d, t_max, eps, color_bug):
        seen["calls"] += 1
        seen["rays"] += o.shape[0]
        return door(scene, o, d, t_max, eps, color_bug)

    def traced(fn, label):
        """``fn`` under the profiler and the tracer, every call of the door
        counted -> (its result, {calls, launches, profiled launches, wide
        ops, counters})."""
        seen.update(calls=0, rays=0)
        families.reset_launches()
        families.closest = counting
        profiling.enable()
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA],
                                        record_shapes=True) as prof:
                out = fn()
                torch.cuda.synchronize()
        finally:
            families.closest = door
            profiling.disable()
        counters = profiling.take()["counters"]
        rec = dict(calls=seen["calls"], launches=families.launches["closest"],
                   profiled=kernel_count(torch, prof, "families_closest_hit_kernel"),
                   wide=wide_ops(torch, prof, "hit.families"),
                   lanes=counters.get("families.lanes.closest", 0), grad_rows=counters.get("families.grad.rows", 0))
        check(rec["launches"] == rec["calls"] > 0 and rec["lanes"] == seen["rays"],
              f"{label}: {rec['launches']} launches for {rec['calls']} calls of the door, lanes {rec['lanes']}")
        check(rec["profiled"] in (0, rec["launches"]), f"{label}: the profile holds {rec['profiled']} launches")
        check(not rec["wide"], f"{label}: ops inside hit.families on wide tensors: {rec['wide'][:5]}")
        return out, rec

    with torch.no_grad():
        img, frame_rec = traced(lambda: render_image(scene, cfg, device=dev), "traced frame")
        check(frame_rec["calls"] == 2 * cfg.recursion_depth, f"traced frame: {frame_rec['calls']} calls")
        families.closest = lambda scene, o, d, t_max, eps, color_bug: families.closest_plain(
            scene, o, d, t_max, eps, color_bug)[1]
        try:
            img_plain = render_image(scene, cfg, device=dev)
        finally:
            families.closest = door
    check(torch.equal(img, img_plain), "the frame differs from the plain version's frame")
    del img, img_plain

    gcfg = dataclasses.replace(cfg, **CLOSEST_GRAD_FRAME)
    with torch.no_grad():
        target = render_for_grad(scene, gcfg) * 0.9
    steps = {}
    for name in ("spheres.color", "spheres.center"):
        leaf = getattr(scene.spheres, name.split(".")[1]).detach().clone().requires_grad_(True)

        def step():
            loss = mse_loss(merge_params(scene, {name: leaf}), target, gcfg)
            loss.backward()
            return float(loss)

        loss, rec = traced(step, f"remat step of {name}")
        check(bool(torch.isfinite(leaf.grad).all()) and float(leaf.grad.abs().max()) > 0,
              f"remat step of {name}: gradient {leaf.grad}")
        rays = gcfg.Width * gcfg.Height
        check(rec["calls"] == 2 * gcfg.recursion_depth, f"remat step of {name}: {rec['calls']} calls")
        check(rec["grad_rows"] == (rec["lanes"] if name == "spheres.center" else 0),
              f"remat step of {name}: {rec['grad_rows']} rows recomputed of {rec['lanes']}")
        steps[name] = dict(rec, loss=loss, rays=rays)
    log(f"phase 6b traced: frame {json.dumps(frame_rec)}, bit-equal to the plain version's; remat steps "
        f"{json.dumps(steps)}; {time.perf_counter() - t0:.1f} s")
    source, replaces = KERNELS["families_closest"]
    return dict(name="families_closest[closest]", route="cuda", source=source, replaces=replaces,
                launches=frame_rec["launches"], max_abs_err=0.0, ms=turns["kernel"], plain_ms=turns["plain"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, rays=tile, bytes=nbytes, operations=ops,
                hits=hits, traced_frame=frame_rec, remat_steps=steps)


def timed_frame(torch, render, quantize_u8) -> dict:
    """A warm call of ``render``, then a timed one with every launch count
    set to 0 just before it and read just after: only the packet walk may
    launch, in both modes -> seconds, launches by mode, the u8 frame."""
    counters = kernel_counters()
    render()
    reset_launches(counters)
    seconds, img = wall_s(torch, render)
    counts = read_launches(counters)
    check(all(counts["packet_traverse"][m] > 0 for m in ("closest", "any_hit")),
          f"sharded frame: the packet walk did not launch in both modes: {counts}")
    check(not launched({k: c for k, c in counts.items() if k != "packet_traverse"}),
          f"sharded frame: another kernel launched: {launched(counts)}")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.01, "sharded frame: not finite, or black")
    return dict(seconds=seconds, launches=counts["packet_traverse"], shape=list(img.shape), u8=quantize_u8(img))


def dp_rank(rank: int, world: int, init: str, step: bool) -> dict:
    """A rank of a dp world on the card (phase 24): the flagship scene
    built and broadcast from rank 0 (``replicate_scene``), its frame
    through ``render_image_sharded``; with ``step``, then phase 26's 1D
    step (``make_train_step`` on DP_PARAMS, remat_bounces, target
    DP_TARGET) twice."""
    import torch

    from dod_raytracer_tpu_torch import Config, default_scene, quantize_u8
    from dod_raytracer_tpu_torch.parallel import multihost, sharding

    backend = multihost.initialize(init, world, rank, device="cuda", timeout_s=DIST_TIMEOUT_S)
    mesh = sharding.make_mesh(world)
    cfg = Config(**FLAGSHIP)
    setup_s, scene = wall_s(torch, lambda: sharding.replicate_scene(
        default_scene(seed=0, cfg=cfg, mesh="dragon").build(cfg, device=mesh.device), mesh))
    out = dict(rank=rank, backend=backend, device=str(mesh.device), setup_s=setup_s)
    out.update(timed_frame(torch, lambda: sharding.render_image_sharded(scene, cfg, mesh), quantize_u8))
    if step:
        gcfg = dataclasses.replace(cfg, remat_bounces=True)
        target = torch.full((cfg.Width * cfg.Height, 3), DP_TARGET, device=mesh.device)
        step_fn = sharding.make_train_step(gcfg, mesh, DP_PARAMS, lr=0.1)
        losses, seconds = [], []
        for _ in range(2):
            sec, (loss, scene) = wall_s(torch, lambda scene=scene: step_fn(scene, target))
            losses.append(float(loss))
            seconds.append(sec)
        out["step"] = dict(losses=losses, seconds=seconds)
    return out


def leaf_rank(rank: int, world: int, init: str, shape: tuple, step: bool) -> dict:
    """A rank of a (dp, mp) = ``shape`` world on the card (phase 25): its
    shard of the flagship scene (``make_leaf_sharded_scene``), the
    frame through ``render_image_leaf_sharded`` with the default sorts,
    then one more frame with the combine's collectives counted
    (``LeafShard.stats``); with ``step``, then phase 26's 2D step
    (remat_bounces, target 0): ``loss_and_vertex_grads_2d`` (this rank's
    gradient, returned from the first dp row) and one
    ``make_train_step_2d`` step."""
    import torch

    from dod_raytracer_tpu_torch import Config, default_scene, quantize_u8
    from dod_raytracer_tpu_torch.ops import packet
    from dod_raytracer_tpu_torch.parallel import leaf_shard, multihost
    from dod_raytracer_tpu_torch.render import _sort_bounces
    from dod_raytracer_tpu_torch.shading import _sort_shadow

    backend = multihost.initialize(init, world, rank, device="cuda", timeout_s=DIST_TIMEOUT_S)
    mesh = multihost.global_mesh(("dp", "mp"), shape)
    cfg = Config(**FLAGSHIP, tri_shard_axis="mp")
    setup_s, scene = wall_s(torch, lambda: leaf_shard.make_leaf_sharded_scene(
        default_scene(seed=0, cfg=cfg, mesh="dragon"), cfg, mesh, device=mesh.device))
    sh, kd = scene.shard, scene.kd
    out = dict(rank=rank, backend=backend, coords=mesh.coords, setup_s=setup_s,
               shard=dict(triangles=scene.triangles.verts.shape[0], offset=sh.offset, nodes=kd.node_flag.shape[0],
                          blocks=kd.block_g.shape[0], whole_nodes=sh.n_nodes, whole_blocks=sh.n_blocks,
                          sort_bounces=_sort_bounces(scene, cfg, mesh.device), sort_shadow=_sort_shadow(scene, cfg)))
    render = lambda: leaf_shard.render_image_leaf_sharded(scene, cfg, mesh)
    out.update(timed_frame(torch, render, quantize_u8))
    sh.stats = leaf_shard.CommStats()
    comm_s = wall_s(torch, render)[0]
    out["comm"] = dict(frame_seconds=comm_s, **dataclasses.asdict(sh.stats))
    sh.stats = None
    if step:
        gcfg = dataclasses.replace(cfg, remat_bounces=True)
        target = torch.zeros((cfg.Width * cfg.Height, 3), device=mesh.device)
        packet.reset_launches()
        gsec, (loss, grad) = wall_s(torch, lambda: leaf_shard.loss_and_vertex_grads_2d(scene, target, gcfg, mesh))
        launches = dict(packet.launches)
        top = grad.abs().max()
        torch.distributed.all_reduce(top, op=torch.distributed.ReduceOp.MAX)  # one lr on every rank
        lr = SGD_MAX_STEP / float(top)
        ssec, (sloss, moved) = wall_s(torch, lambda: leaf_shard.make_train_step_2d(gcfg, mesh, lr=lr)(scene, target))
        check(math.isclose(float(sloss), float(loss), rel_tol=1e-5), f"2D step: loss {float(sloss)} vs {float(loss)}")
        check(torch.equal(moved.kd.block_tris,
                          leaf_shard.refresh_kd_blocks_stacked(scene.kd, moved.triangles.verts).block_tris),
              "2D step: the blocks were not refreshed from the moved vertices")
        out["step_2d"] = dict(loss=float(loss), grad_seconds=gsec, step_seconds=ssec, lr=lr, launches=launches,
                              moved=float((moved.triangles.verts - scene.triangles.verts).abs().max()),
                              grad=grad.cpu().numpy() if mesh.coords["dp"] == 0 else None)
    return out


def host_runtime(card: str) -> dict:
    """Phase 2b (see the module docstring) -> its numbers; fails if a
    native library does not build or a tree or a parse differs."""
    import numpy as np

    from dod_raytracer_tpu_torch import Config, native
    from dod_raytracer_tpu_torch.accel import _kdtree_np
    from dod_raytracer_tpu_torch.mesh import load_mesh_asset, load_obj
    from dod_raytracer_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    builds = [native_build.build(name, force=True) for name in native_build.SOURCES]  # raises on a failure
    for name in native_build.SOURCES:
        native._load(name)  # raises NativeUnavailable: no silent fallback here
    out = {"card": card, "builds": {b["name"]: {"seconds": b["seconds"], "path": os.path.relpath(b["path"], ROOT)}
                                    for b in builds}, "gxx_flags": native_build.GXX_FLAGS}
    t = time.perf_counter()
    tv = load_mesh_asset("dragon")[0]
    out["dragon_load_s"] = time.perf_counter() - t
    trees = {}
    for label, cfg in (("config_ini", Config.load(os.path.join(ROOT, "config.ini"))),
                       ("flagship", Config(**FLAGSHIP))):
        kw = dict(lane_size=cfg.lane_size, max_prims=cfg.MaxPrims, intersect_cost=float(cfg.IntersectCost),
                  traversal_cost=float(cfg.TraversalCost), empty_bonus=float(cfg.EmptyBonus))
        fns = {"native": native.kdtree_native.build, "numpy": _kdtree_np.build}
        secs, built = {"native": [], "numpy": []}, {}
        for name in ("native", "numpy", "native"):  # in turns
            t = time.perf_counter()
            built[name] = fns[name](tv, **kw)
            secs[name].append(time.perf_counter() - t)
        a, b = built["native"], built["numpy"]
        differ = [f.name for f in dataclasses.fields(a)
                  if not (np.array_equal(np.asarray(getattr(a, f.name)).view(np.uint8),
                                         np.asarray(getattr(b, f.name)).view(np.uint8))
                          if isinstance(getattr(b, f.name), np.ndarray) else getattr(a, f.name) == getattr(b, f.name))]
        check(not differ, f"dragon tree at MaxPrims={cfg.MaxPrims}: native and numpy differ in {differ}")
        trees[label] = dict(MaxPrims=cfg.MaxPrims, leaf_chunk_lanes=cfg.leaf_chunk_lanes, nodes=int(a.node_flag.shape[0]),
                            leaves=int((a.node_flag == _kdtree_np.LEAF_FLAG).sum()), depth=a.max_depth,
                            lanes=int(a.prim_nums.shape[0]), bit_equal=True, native_s=secs["native"],
                            numpy_s=secs["numpy"])
        del built, a, b
    out["dragon_trees"] = trees
    path = os.path.join(ROOT, "assets", "teapot.obj")
    secs, parsed = {"native": [], "python": []}, {}
    for name in ("native", "python", "python", "native"):
        t = time.perf_counter()
        parsed[name] = load_obj(path, use_native=name == "native")
        secs[name].append(time.perf_counter() - t)
    (vc, fc, nc), (vp, fp, np_) = parsed["native"], parsed["python"]
    check(np.array_equal(fc, fp) and vc.shape == vp.shape and (nc is None) == (np_ is None),
          "teapot.obj: the native parser's faces or shapes differ from the Python parser's")
    ulps = np.abs(vc.view(np.int32).astype(np.int64) - vp.view(np.int32).astype(np.int64))
    out["teapot_obj"] = dict(vertices=int(vc.shape[0]), faces=int(fc.shape[0]), coords_differ=int((ulps != 0).sum()),
                             max_ulps=int(ulps.max()), native_s=secs["native"], python_s=secs["python"])
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"host_runtime": out}), flush=True)
    log(f"phase 2b host runtime on the host of {card}: g++ {' '.join(native_build.GXX_FLAGS)}: "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in out["builds"].items())
        + f"; dragon ({tv.shape[0]} triangles, load {out['dragon_load_s']:.2f} s) trees bit-equal, in turns: "
        + "; ".join(f"MaxPrims={v['MaxPrims']} ({v['nodes']} nodes) native {json.dumps(v['native_s'])} s, numpy "
                    f"{json.dumps(v['numpy_s'])} s" for v in trees.values())
        + f"; teapot.obj {out['teapot_obj']['coords_differ']} coordinates differ (max {out['teapot_obj']['max_ulps']} "
        f"ulp), native {json.dumps(secs['native'])} s, Python {json.dumps(secs['python'])} s")
    return out


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from dod_raytracer_tpu_torch import Config, default_scene, quantize_u8, render_image
    from dod_raytracer_tpu_torch.intersect import closest_families, closest_hit, occluded_families
    from dod_raytracer_tpu_torch.ops import _cuda, binned, brute, families, forest, mega, mt, packet, plucker
    from dod_raytracer_tpu_torch.ops.traverse import (_PLAIN_CHUNK, _backend, _stack_depth, _walk, leaf_plain,
                                                      traverse_forest_plain, traverse_plain)
    from dod_raytracer_tpu_torch.ops.triangle import (block_edge_rows, brute_force_closest, edge_sign_brute_any,
                                                      edge_sign_brute_closest, mt_single, mt_t_edges,
                                                      occluded_triangles_brute)
    from dod_raytracer_tpu_torch.render import _sort_bounces, frame_rays, render_rays
    from dod_raytracer_tpu_torch.shading import _sort_shadow, light_terms, shadow_rays
    from dod_raytracer_tpu_torch.utils.math import reflect

    dev = torch.device(device)
    walks = {  # warp walk -> (the wrapper, its plain walk, the per-ray kernel it replaced)
        "packet_traverse": (packet.packet_traverse, traverse_plain, packet.packet_traverse_per_ray),
        "mega_walk": (mega.mega_traverse, traverse_plain, mega.mega_traverse_per_ray),
        "forest_walk": (forest.forest_traverse, traverse_forest_plain, forest.forest_traverse_per_ray),
    }
    per_ray = packet.packet_traverse_per_ray
    packet_walk = packet.packet_traverse  # the frame's kernel
    counters = kernel_counters()
    BINNED = ("block_loop", "binned_descend")  # the binned walk's two kernels
    family_launches = {}  # frame path -> launches of the families' any-hit kernel in its timed frame
    family_parity = {"calls": 0, "lanes": 0, "blocked": 0}  # the kernel vs its plain version, every lane equal

    def reset_counts():
        reset_launches(counters)

    def read_counts():
        return read_launches(counters)

    def frame(scene, cfg, path: str, only, modes=("closest", "any_hit")):
        """One timed frame of the main path ``path``: every count set to 0
        just before it and read just after; only kernel ``only`` (None: no
        kernel; a tuple: those kernels) may have launched, and each of them
        in each of ``modes``.  -> (seconds, image, the launches of ``only``:
        by mode, or by kernel and mode for a tuple)."""
        kernels_of = () if only is None else ((only,) if isinstance(only, str) else tuple(only))
        reset_counts()
        families.reset_launches()
        seconds, img = wall_s(torch, lambda: render_image(scene, cfg, device=dev))
        counts = read_counts()
        family_launches[path] = families.launches["any"]
        check(family_launches[path] > 0, f"{path}: the families' any-hit kernel did not launch")
        check(all(counts[k][m] > 0 for k in kernels_of for m in modes),
              f"{path}: {only} not launched in modes {modes}: {counts}")
        check(all(sum(c.values()) == 0 for k, c in counts.items() if k not in kernels_of),
              f"{path}: another kernel launched: {counts}")
        check(tuple(img.shape) == (cfg.Height, cfg.Width, 3), f"{path}: frame shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{path}: frame has non-finite values")
        check(float(img.mean()) > 0.01, f"{path}: frame is black (mean {float(img.mean())})")
        if isinstance(only, str):
            return seconds, img, counts[only]
        return seconds, img, {k: counts[k] for k in kernels_of}

    @contextlib.contextmanager
    def frame_walk(walk):
        """Frames inside take ``walk`` where the dispatch takes the packet
        walk (ops/traverse.py reads ``packet.packet_traverse`` at each call)."""
        packet.packet_traverse = walk
        try:
            yield
        finally:
            packet.packet_traverse = packet_walk

    def sort_samples(scene, base, reps=SORT_REPS, knob="sort_bounces"):
        """Frame seconds with ``knob`` on and off, ``reps`` each, timed in
        turns (on, off, off, on, on, off, ...) -> {on: [...], off: [...]}."""
        order = [True, False, False, True] * reps
        out = {True: [], False: []}
        for on in order[:2 * reps]:
            out[on].append(wall_s(torch, lambda: render_image(
                scene, dataclasses.replace(base, **{knob: on}), device=dev))[0])
        return {"on": out[True], "off": out[False]}

    def frame_set(scene, base, label, variants):
        """The default frame of ``base`` (one warm, one timed), then each
        of ``variants`` (name -> (config overrides, walk)), timed once and
        held to the default frame: u8 channels off by > 1 under the golden
        1%.  -> ({name: seconds}, {name: u8 share off}, {name: launches},
        the default frame, the per-ray frame)."""
        wall_s(torch, lambda: render_image(scene, base, device=dev))
        secs, offs, counts, imgs = {}, {}, {}, {}
        secs["default"], imgs["default"], counts["default"] = frame(scene, base, label, "packet_traverse")
        for name, (over, walk) in variants.items():
            only = "packet_traverse_per_ray" if walk is per_ray else "packet_traverse"
            with frame_walk(walk):
                secs[name], img_v, counts[name] = frame(scene, dataclasses.replace(base, **over),
                                                        f"{label} ({name})", only)
            offs[name] = u8_off(quantize_u8, img_v, imgs["default"])
            check(offs[name] < U8_TOLERANCE, f"{label} ({name}): {offs[name]:.4%} of u8 channels off by > 1")
            if walk is per_ray:
                imgs["per_ray"] = img_v
            del img_v
        return secs, offs, counts, imgs["default"], imgs["per_ray"]

    # ---- 1. the card ----
    card = card_line()
    print(card, flush=True)
    log(f"phase 1 card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. kernel builds, in parallel ----
    t = time.perf_counter()
    builds = _cuda.build_all(SOURCES, force=True)
    for b in builds:
        for line in b["log"].splitlines():
            if b["name"] in ("packet_traverse", "kd_walk", "mt_closest", "plucker_closest", "families_any",
                             "families_closest") \
                    or "registers" in line or "spill" in line \
                    or "stack frame" in line:
                print(f"  ptxas {b['name']}:", line.strip(), flush=True)
    for module in (packet, mega, binned, mt, plucker):
        module._fn()
    for module in (packet, mega, binned, mt, plucker):
        module._fn_per_ray()
    binned._fn_descend()
    families._fn()
    families._fn_closest()
    log("phase 2 build: " + ", ".join(f"{b['name']}.cu nvcc {b['seconds']:.2f} s -> "
                                      f"{os.path.relpath(b['path'], ROOT)}" for b in builds)
        + f"; {time.perf_counter() - t:.2f} s wall")

    # ---- 2b. the host runtime: the native kd builder and OBJ parser ----
    host = host_runtime(card)

    # ---- 3. teapot scene ----
    t = time.perf_counter()
    cfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0)
    scene = default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device=dev)
    torch.cuda.synchronize()
    kd = scene.kd
    log(f"phase 3 scene: {cfg.Width}x{cfg.Height}, {scene.n_triangles} triangles, "
        f"{kd.node_flag.shape[0]} nodes, {kd.block_g.shape[0]} blocks of {kd.block_orig.shape[1]} slots, "
        f"{scene.n_spheres} spheres, {scene.n_planes} planes, {scene.n_cylinders} cylinder, "
        f"{scene.n_lights} lights, depth {cfg.recursion_depth}, built in {time.perf_counter() - t:.2f} s")

    # ---- 4. teapot frames ----
    sort_default = _sort_bounces(scene, cfg, dev)
    teapot_frames = frame_set(scene, cfg, "teapot frame", {
        "per_ray": ({}, per_ray),
        f"sort_bounces={not sort_default}": ({"sort_bounces": not sort_default}, packet_walk)})
    teapot_sorts = sort_samples(scene, cfg)
    log(f"phase 4 teapot frame seconds with sort_bounces on and off, in turns: {json.dumps(teapot_sorts)}")
    frame_s, counts = teapot_frames[0]["default"], teapot_frames[2]["default"]
    img, img_pr = teapot_frames[3], teapot_frames[4]
    teapot_ref = img  # phase 4's frame, held by phases 20, 22 and 23
    mean = float(img.mean())
    pixels = cfg.Width * cfg.Height
    log(f"phase 4 frames (sort_bounces={sort_default} by default, sort_shadow={_sort_shadow(scene, cfg)}): "
        f"seconds {json.dumps(teapot_frames[0])}, u8 channels off by > 1 from the default frame "
        f"{json.dumps(teapot_frames[1])}, launches {json.dumps(teapot_frames[2])}, families_any launches by "
        f"frame {json.dumps(family_launches)}; "
        f"{pixels / frame_s:.0f} primary rays/s, mean {mean:.4f}")

    # a small frame on the card (kernel) against the CPU path (plain walk)
    small = Config.load(os.path.join(ROOT, "config.ini"), Width=64, Height=32,
                        MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0)
    img_gpu = render_image(default_scene(seed=0, cfg=small, mesh="teapot").build(small, device=dev),
                           small, device=dev)
    img_cpu = render_image(default_scene(seed=0, cfg=small, mesh="teapot").build(small, device="cpu"),
                           small, device="cpu")
    far = float((img_gpu.cpu() - img_cpu).abs().gt(2e-3).float().mean())
    small_off = u8_off(quantize_u8, img_gpu, img_cpu)
    check(small_off < U8_TOLERANCE,
          f"64x32 frame: {small_off:.4%} of u8 channels differ by more than 1 from the CPU path")
    log(f"phase 4 small frame vs CPU path: {far:.4%} of channels off by > 2e-3, "
        f"{small_off:.4%} of u8 channels off by > 1")

    # ---- parity helpers (phases 5 and 11) ----
    def allowed(n):
        return math.floor(n * (1.0 - MASK_AGREEMENT))

    edge_rows = {}  # verts.data_ptr() -> the (1, 6, 3, T) edge rows of the edge-sign brute force

    def brute_closest(verts, o, d):
        parts = [brute_force_closest(verts, o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                 for s in range(0, o.shape[0], RAY_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def brute_any(verts, o, d, tm):
        return torch.cat([occluded_triangles_brute(verts, o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                                                   tm[s:s + RAY_CHUNK])
                          for s in range(0, o.shape[0], RAY_CHUNK)])

    def mt_t_of(verts, prim, o, d):
        tri = verts[prim.long()]
        return mt_single(tri, o, d, torch.ones(o.shape[0], dtype=torch.bool, device=dev))[0]

    def mt_t_exact(verts, prim, o, d):
        """The Möller–Trumbore t of triangle ``prim`` for each ray, with
        the kernels' roundings (``mt_t_edges``), whatever its barycentrics."""
        tri = verts[prim.long()]
        A = tri[:, None, 0]
        return mt_t_edges(A, tri[:, None, 1] - A, tri[:, None, 2] - A, o, d,
                          torch.ones((o.shape[0], 1), dtype=torch.bool, device=dev))[:, 0]

    def closest_refs(kd, verts, depth, o, d, tt, plains, n_brute, brute=brute_closest):
        """Reference (t, prim, hit) of a closest-hit query: each plain walk
        on all rays, brute force (``brute``) on the first n_brute; and each
        plain walk's outputs (t, prim, found)."""
        refs, raws = {}, {}
        for name, walk in plains.items():
            raws[name] = tp, pp, fp = walk(kd, o, d, tt, depth, False)
            refs[name] = (tp, pp, fp & (tp < tt), o.shape[0])
        tb, pb = brute(verts, o[:n_brute], d[:n_brute])
        refs["brute"] = (tb, pb, tb < tt[:n_brute], n_brute)
        return refs, raws

    def check_warp(label, kname, kd, out, raws, o, d):
        """A warp walk's closest hits against each other walk's outputs
        ``raws`` (name -> (t, prim, found)) under the packet rule (module
        docstring); ``bits_equal``: every output bit equal besides."""
        res = {}
        for name, ref in raws.items():
            r = packet.parity(kd, out, ref, o, d, False)
            holds = packet.parity_holds(r)
            both = out[2] & ref[2]
            r["max_abs_t_err"] = float((out[0] - ref[0])[both].abs().max()) if bool(both.any()) else 0.0
            r["bits_equal"] = all(torch.equal(a, b) for a, b in zip(out, ref))
            res[name] = r
            check(holds, f"{kname} closest parity {label} vs {name}: {r}")
        log(f"phase parity {kname} closest {label}: {json.dumps(res)}")
        return res

    def packet_stats(kd, inputs, depth, any_hit, walk=None):
        """A warp walk's measurement build on ``inputs`` (default: the
        packet walk) -> its counts summed over the warps, and the lane
        occupancy: wanting lanes over 32 x blocks staged."""
        st = torch.zeros(((inputs[0].shape[0] + 31) // 32, len(packet.STATS)), dtype=torch.int32, device=dev)
        (walk or packet_walk)(kd, *inputs, depth, any_hit, stats=st)
        tot = dict(zip(packet.STATS, (int(x) for x in st.sum(0, dtype=torch.int64))))
        tot["warps"] = st.shape[0]
        tot["lane_occupancy"] = tot["wanting_lanes"] / (32 * tot["blocks_staged"]) if tot["blocks_staged"] else 0.0
        return tot

    def record_tile(scene, cfg, o, d, raw):
        """Every traversal launch of one tile's ``render_rays`` under
        ``cfg``, in order -> [(mode, (o, d, t_max), stack depth)]."""
        launched = []

        def record(kd_, o_, d_, t_, depth_, any_hit_):
            launched.append(("any_hit" if any_hit_ else "closest", (o_, d_, t_), depth_))
            return packet_walk(kd_, o_, d_, t_, depth_, any_hit_)

        with frame_walk(record), torch.no_grad():
            render_rays(scene, o, d, raw, cfg)
        return launched

    def per_bounce(label, scene, cfg, o, d, raw, other):
        """The packet walk and warp walk ``other`` (mega_walk or
        forest_walk), each beside the per-ray walk it replaced, on every
        traversal launch of one tile's render, with the bounce sort on and
        off: ms per launch in turns (per-ray, packet, other's per-ray,
        other, and back; BOUNCE_REPS after 1 warm), both warp walks'
        counts, and each one's parity with its per-ray walk on those
        inputs."""
        owalk, _, oper = walks[other]
        rows = []
        for sort in (True, False):
            bounce = {"closest": 0, "any_hit": 0}
            for mode, inputs, depth in record_tile(scene, dataclasses.replace(cfg, sort_bounces=sort), o, d, raw):
                any_hit = mode == "any_hit"
                par = {}
                for name, (walk, _, per_ray_walk) in walks.items():
                    if name in ("packet_traverse", other):
                        par[name] = packet.parity(scene.kd, walk(scene.kd, *inputs, depth, any_hit),
                                                  per_ray_walk(scene.kd, *inputs, depth, any_hit), inputs[0],
                                                  inputs[1], any_hit)
                        check(packet.parity_holds(par[name]), f"{label} per-bounce parity of {name}, sort_bounces="
                                                              f"{sort}, {mode} bounce {bounce[mode]}: {par[name]}")
                ms = time_turns(torch, {"per_ray": lambda: per_ray(scene.kd, *inputs, depth, any_hit),
                                        "packet": lambda: packet_walk(scene.kd, *inputs, depth, any_hit),
                                        "other_per_ray": lambda: oper(scene.kd, *inputs, depth, any_hit),
                                        "other": lambda: owalk(scene.kd, *inputs, depth, any_hit)},
                                BOUNCE_REPS, warm=1)
                rows.append(dict(sort_bounces=sort, mode=mode, bounce=bounce[mode], rays=inputs[0].shape[0],
                                 live_rays=int((inputs[2] >= 0).sum()), per_ray_ms=ms["per_ray"],
                                 packet_ms=ms["packet"], **{f"{other}_per_ray_ms": ms["other_per_ray"],
                                                            f"{other}_ms": ms["other"]},
                                 parity=par["packet_traverse"], **{f"{other}_parity": par[other]},
                                 **packet_stats(scene.kd, inputs, depth, any_hit),
                                 **{f"{other}_stats": packet_stats(scene.kd, inputs, depth, any_hit, owalk)}))
                bounce[mode] += 1
        print(json.dumps({"per_bounce": {"scene": label, "rows": rows}}), flush=True)
        for sort in (True, False):
            for mode in ("closest", "any_hit"):
                sel = [r for r in rows if r["sort_bounces"] == sort and r["mode"] == mode]
                fmt = lambda key: ", ".join(f"{r[key]:.3f}" for r in sel)
                log(f"per-bounce {label} {mode} sort_bounces={sort}: packet ms {fmt('packet_ms')}; per-ray ms "
                    f"{fmt('per_ray_ms')}; {other} ms {fmt(other + '_ms')}; its per-ray ms "
                    f"{fmt(other + '_per_ray_ms')}; lane occupancy {fmt('lane_occupancy')}")
        return rows

    def attach_bounces(entries, rows, other):
        """Give the packet walk's and ``other``'s entries of a scene their
        sums over the per-bounce rows, by bounce sort (warp walk ms, its
        per-ray walk's ms); the packet entries also get the rows."""
        for e in entries:
            name, mode = e["name"].split("[")[0], e["name"].split("[")[1].split(",")[0].rstrip("]")
            if name not in ("packet_traverse", other):
                continue
            sel = [r for r in rows if r["mode"] == mode]
            keys = ("packet_ms", "per_ray_ms") if name == "packet_traverse" else (f"{other}_ms", f"{other}_per_ray_ms")
            e["per_bounce_sums"] = {f"sort_bounces={sort}": {
                "warp_ms": sum(r[keys[0]] for r in sel if r["sort_bounces"] == sort),
                "per_ray_ms": sum(r[keys[1]] for r in sel if r["sort_bounces"] == sort)} for sort in (True, False)}
            if name == "packet_traverse":
                e["per_bounce"] = sel

    def edge_distance(verts, prim, o, d):
        """Barycentric distance of each ray's crossing of triangle ``prim``
        from the triangle's nearest edge (Möller–Trumbore u, v, 1-u-v)."""
        _, u, v = mt_single(verts[prim.long()], o, d, torch.ones(o.shape[0], dtype=torch.bool, device=dev))
        return torch.minimum(torch.minimum(u.abs(), v.abs()), (1.0 - u - v).abs())

    def at_edge(verts, o, d, k_hit, k_prim, r_hit, r_prim):
        """Rays whose kernel or brute-force triangle is met within EDGE_EPS
        of an edge: there the kernels' Plücker edge signs and brute force's
        barycentric test can disagree on which triangle of a shared edge a
        ray meets, or whether it meets one."""
        near = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
        for hit, prim in ((k_hit, k_prim), (r_hit, r_prim)):
            if prim is not None and bool(hit.any()):
                near[hit] |= edge_distance(verts, prim[hit], o[hit], d[hit]) < EDGE_EPS
        return near

    edge_cache = {}  # id(a brute-force reference) -> (it, done, the edge-sign outputs on its rays so far)

    def edge_sign_on(ref, verts, o, d, sel, tm=None):
        """The edge-sign brute force (the kernels' own leaf test over every
        triangle, on the edge rows of ``edge_rows[verts]``) on the rays
        ``sel`` of the query (o, d) whose barycentric reference is ``ref``:
        closest (t, prim), or with ``tm`` the any-hit bits.  Each ray is
        computed once, however many kernels ask for it; the chunk of
        triangles is as wide as keeps a temporary near 16 MB."""
        c = edge_cache.get(id(ref))
        if c is None or c[0] is not ref:
            n = sel.shape[0]
            c = edge_cache[id(ref)] = (ref, torch.zeros(n, dtype=torch.bool, device=dev),
                                       torch.full((n,), float("inf"), device=dev),
                                       torch.zeros(n, dtype=torch.int32, device=dev))
        _, done, t, idx = c
        need = sel & ~done
        k = int(need.sum())
        if k:
            g, chunk = edge_rows[verts.data_ptr()], max(2048, min(1 << 17, (1 << 22) // k))
            if tm is None:
                t[need], idx[need] = edge_sign_brute_closest(verts, o[need], d[need], g=g, chunk=chunk)
            else:
                idx[need] = edge_sign_brute_any(verts, o[need], d[need], tm[need], g=g, chunk=chunk).to(torch.int32)
            done |= need
        return (t[sel], idx[sel]) if tm is None else idx[sel].bool()

    def edge_sign_closest(ref, verts, o, d, tt, sel, hk, tk, pk):
        """The kernel's closest hits (hk, tk, pk) on the rays ``sel`` of the
        query (o, d) with clip tt against the edge-sign brute force: hit
        masks equal, t bit-equal where both hit, and a prim may differ
        only there (a tie of bit-equal Möller–Trumbore t).  -> counts."""
        r = dict(rays=int(sel.sum()), hits=0, mask_mismatch=0, t_not_exact=0, ties=0)
        if r["rays"]:
            te, ie = edge_sign_on(ref, verts, o, d, sel)
            he = te < tt[sel]
            hk, tk, pk = hk[sel], tk[sel], pk[sel]
            both = hk & he
            r.update(hits=int(he.sum()), mask_mismatch=int((hk != he).sum()),
                     t_not_exact=int((both & (tk != te)).sum()), ties=int((both & (pk != ie)).sum()))
        r["equal"] = r["mask_mismatch"] == 0 and r["t_not_exact"] == 0
        return r

    def check_closest(label, kname, out, refs, verts, o, d, tt):
        """The kernel's closest hits against each reference: bit for bit
        against the plain walks and the other kernels; against ``brute``
        (barycentric), every ray that differs goes through the edge-sign
        brute force, which the kernel must equal with no edge excuse (module
        docstring); the barycentric at-edge count is the reference side."""
        tk, pk, fk = out
        hk_all = fk & (tk < tt)
        res = {}
        for name, (tr, pr, hr, n) in refs.items():
            hk, tkn, pkn, on, dn = hk_all[:n], tk[:n], pk[:n], o[:n], d[:n]
            both = hk & hr
            flip = both & (pkn != pr)
            r = dict(rays=n, hits=int(hr.sum()), mask_mismatch=int((hk != hr).sum()),
                     prim_flips=int(flip.sum()), t_not_exact=int((both & (tkn != tr)).sum()),
                     max_abs_t_err=float((tkn - tr)[both].abs().max()) if bool(both.any()) else 0.0)
            r["bits_equal"] = r["mask_mismatch"] == 0 and r["prim_flips"] == 0 and r["t_not_exact"] == 0
            ok = r["bits_equal"]
            if name == "brute":
                tie = torch.zeros_like(flip)
                if bool(flip.any()):
                    ta, tb2 = mt_t_of(verts, pkn[flip], on[flip], dn[flip]), mt_t_of(verts, pr[flip], on[flip], dn[flip])
                    tie[flip] = (ta - tb2).abs() <= TIE_RTOL * tb2.abs()
                differ = (hk != hr) | (flip & ~tie)
                edge = differ & at_edge(verts, on, dn, differ & hk, pkn, differ & hr, pr)
                odd = differ & ~edge
                t_bad = both & ~tie & ~edge & ((tkn - tr).abs() > T_RTOL * tr.abs())
                es = edge_sign_closest(tr, verts, on, dn, tt[:n], (hk != hr) | flip, hk, tkn, pkn)
                r.update(ties=int(tie.sum()), at_edge=int(edge.sum()),
                         unexplained_mask=int((odd & (hk != hr)).sum()), unexplained_flips=int((odd & flip).sum()),
                         t_out_of_rtol=int(t_bad.sum()), edge_sign=es)
                ok = (es["equal"] and r["unexplained_mask"] <= allowed(n) and r["unexplained_flips"] == 0
                      and r["t_out_of_rtol"] == 0)
            res[name] = r
            check(ok, f"{kname} closest parity {label} vs {name}: {r}")
        log(f"phase parity {kname} closest {label}: {json.dumps(res)}")
        return res

    def check_any(label, kname, out, refs, verts, o, d, tm):
        """The kernel's hit bits against each reference: ``refs[name]`` is
        (prim or None, bits, n) for the first n rays.  Bit for bit against
        the plain walks and the other kernels; against ``brute``
        (barycentric), every ray that differs must have the bit of the
        edge-sign brute force (the kernels' own leaf test, t_max ``tm``),
        with no edge excuse; the mismatches away from an edge (see
        ``at_edge``) stay within the 0.001% allowance."""
        _, pk, fk = out
        res = {}
        for name, (pr, fr, n) in refs.items():
            on, dn = o[:n], d[:n]
            differ = fk[:n] != fr
            r = dict(rays=n, occluded=int(fr.sum()), mask_mismatch=int(differ.sum()))
            r["bits_equal"] = r["mask_mismatch"] == 0
            ok = r["bits_equal"]
            if name == "brute":
                if pr is None and bool(differ.any()):  # find the occluder brute force saw
                    pr = torch.full((n,), -1, dtype=torch.int32, device=dev)
                    pr[differ] = brute_closest(verts, on[differ], dn[differ])[1].to(torch.int32)
                edge = differ & at_edge(verts, on, dn, differ & fk[:n], pk[:n], differ & fr, pr)
                es = dict(rays=int(differ.sum()), mask_mismatch=0)
                if es["rays"]:
                    ea = edge_sign_on(fr, verts, on, dn, differ, tm[:n])
                    es["mask_mismatch"] = int((ea != fk[:n][differ]).sum())
                r.update(at_edge=int(edge.sum()), unexplained=int((differ & ~edge).sum()), edge_sign=es)
                ok = es["mask_mismatch"] == 0 and r["unexplained"] <= allowed(n)
            res[name] = r
            check(ok, f"{kname} any-hit parity {label} vs {name}: {r}")
        log(f"phase parity {kname} any-hit {label}: {json.dumps(res)}")
        return res

    def check_any_t_prim(label, out, plain_outs):
        """The binned walk's any-hit t and prim against each plain walk's,
        bit for bit: both take the closest hit of the block where a ray
        first hits (the per-ray kernels stop at that block's first hit
        slot, so only their hit bits are compared)."""
        for name, ref in plain_outs.items():
            nt, np_ = int((out[0] != ref[0]).sum()), int((out[1] != ref[1]).sum())
            check(nt == 0 and np_ == 0, f"binned walk any-hit {label} vs {name}: {nt} t and {np_} prims differ")
        log(f"phase parity binned walk any-hit {label}: t and prim equal to {', '.join(plain_outs)} bit for bit")

    def plain_err(par, mode, plains):
        """A kernel's ``max_abs_err`` against its plain versions over both
        parity bounces: |t| where both hit (closest), hit bits (any-hit)."""
        key = "closest" if mode == "closest" else "any"
        return max(par[f"{key}_b{b}"][name]["max_abs_t_err"] if mode == "closest"
                   else float(par[f"{key}_b{b}"][name]["mask_mismatch"] > 0)
                   for b in (0, LATER_BOUNCE) for name in plains)

    def best_window(scene, cfg, walk, depth, width=None):
        """Frame rays, the ray tile, and the start of the window of ``width``
        rays (default: one tile) whose primary rays hit the mesh most often."""
        o_all, d_all, raw_all, _, tile = frame_rays(cfg, dev)
        width = width or tile
        t_inf = torch.full((o_all.shape[0],), float("inf"), device=dev)
        t_tri = torch.minimum(closest_families(scene, o_all, d_all, cfg, t_inf).t, t_inf)
        tk, _, fk = walk(scene.kd, o_all, d_all, t_tri, depth, False)
        start = int((fk & (tk < t_tri)).reshape(-1, width).sum(1).argmax()) * width
        return o_all, d_all, raw_all, tile, start

    def bounces(scene, cfg, o, d, raw, wanted, n_pts):
        """Walk the bounces of a ray window as render_rays does; for each
        bounce in ``wanted`` yield (k, closest-hit query (o, d, t_tri),
        shadow query (so, sd, st) of the first n_pts hit points)."""
        active = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        for k in range(max(wanted) + 1):
            t_max = torch.where(active, float("inf"), -1.0)
            t_tri = torch.minimum(closest_families(scene, o, d, cfg, t_max).t, t_max)
            hit = closest_hit(scene, o, d, cfg, t_max=t_max)
            active = active & hit.mask
            if k in wanted:
                shade, _ = light_terms(scene, hit.point[:n_pts], hit.normal[:n_pts], raw[:n_pts])
                so, sd, st = shadow_rays(scene, hit.point[:n_pts], active[:n_pts], shade > 0.0)
                fam = occluded_families(scene, so, sd, st, cfg)
                check_families(scene, (so, sd, st), fam, cfg, f"bounce {k}")
                st = torch.where(fam, -1.0, st)
                yield k, (o, d, t_tri), (so.contiguous(), sd.contiguous(), st.contiguous())
            d_new = reflect(d, hit.normal)
            o = torch.where(active[:, None], hit.point + d_new * cfg.Epsilon, o)
            d = torch.where(active[:, None], d_new, d)

    def check_families(scene, inputs, got, cfg, label):
        """The families' any-hit kernel's bits ``got`` on ``inputs`` against
        its plain version on the card: every lane equal."""
        ref = families.occluded_plain(scene, *inputs, cfg.Epsilon)
        differ = int((got != ref).sum())
        check(differ == 0, f"families_any {label}: {differ} of {got.shape[0]} lanes differ from the plain version")
        family_parity["calls"] += 1
        family_parity["lanes"] += got.shape[0]
        family_parity["blocked"] += int(ref.sum())

    def families_entry(scene, cfg, o_all, d_all, raw_all, launches):
        """The families' any-hit kernel at the benchmark frame's shape: the
        shadow wavefront of bounce 0 of the frame's first ``FAMILY_TILE``
        rays, timed in turns with its plain version -> one entry of the
        ``kernels`` line."""
        n = min(FAMILY_TILE, o_all.shape[0])
        o, d, raw = o_all[:n], d_all[:n], raw_all[:n]
        hit = closest_hit(scene, o, d, cfg)
        shade, _ = light_terms(scene, hit.point, hit.normal, raw)
        so, sd, st = (x.contiguous() for x in shadow_rays(scene, hit.point, hit.mask, shade > 0.0))
        del hit, shade
        eps = cfg.Epsilon
        turns = time_turns(torch, {"kernel": lambda: families.occluded_any(scene, so, sd, st, eps),
                                   "plain": lambda: families.occluded_plain(scene, so, sd, st, eps)}, TIMING_REPS)
        check_families(scene, (so, sd, st), families.occluded_any(scene, so, sd, st, eps), cfg, "timing lanes")
        lanes = so.shape[0]
        n_cyl = min(scene.n_cylinders, scene.cylinders.base.shape[0])
        ops = lanes * (scene.spheres.center.shape[0] * FAMILY_OPS["sphere"]
                       + scene.planes.point.shape[0] * FAMILY_OPS["plane"] + n_cyl * FAMILY_OPS["cylinder"])
        nbytes = lanes * FAMILY_LANE_BYTES
        bound_ms, bound_by = bound(nbytes, ops)
        source, replaces = KERNELS["families_any"]
        entry = dict(name="families_any[any]", route="cuda", source=source, replaces=replaces, launches=launches,
                     max_abs_err=0.0, ms=turns["kernel"], plain_ms=turns["plain"], bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None, rays=lanes, bytes=nbytes, operations=ops,
                     killed=int((st < 0).sum()), parity=dict(family_parity))
        log(f"phase times families_any[any]: {lanes} lanes, kernel {entry['ms']:.4f} ms/launch, plain "
            f"{entry['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {ops} operations "
            f"with no early exit), {entry['killed']} lanes killed; parity so far {json.dumps(family_parity)}")
        return entry

    def work_bound(walk, kd, inputs, depth, any_hit, nodes_bytes):
        """The least time the card could take for the work that the per-ray
        walk ``walk`` counts on ``inputs`` in its measurement build
        (``stats`` per ray, ``touched`` marks per block and slot) -> dict
        of the bound and its terms.  The larger of two times:
          * bytes over 3.35 TB/s: each ray's o, d, t_max read and t, prim,
            found written once; the node tables and world bounds whole
            (``nodes_bytes``, under 0.1% of the total); block_aabb of the
            blocks whose AABB was read (24 bytes), rows 0-5 of block_g's
            edge sections for the non-empty slots of the blocks edge-tested
            (18 floats), block_tris of the slots whose distance was computed
            (9 floats), and block_orig of the distinct triangles returned;
          * fp32 operations over 67 TFLOP/s: 33 per edge-sign test of a
            non-empty slot (18 products, 15 sums) and 33 per
            Möller–Trumbore distance."""
        n = inputs[0].shape[0]
        B, S = kd.block_orig.shape
        stats = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        touched = torch.zeros((B, 2 + S), dtype=torch.int32, device=dev)
        _, prim, found = walk(kd, *inputs, depth, any_hit, stats=stats, touched=touched)
        node_steps, blocks, slots, mt_slots = (int(x) for x in stats.sum(0, dtype=torch.int64))
        aabb_blocks = int(touched[:, 0].sum(dtype=torch.int64))
        edge_blocks = touched[:, 1] > 0
        g_slots = int((kd.block_orig[edge_blocks] >= 0).sum())
        tri_slots = int(touched[:, 2:].sum(dtype=torch.int64))
        winners = int(torch.unique(prim[found]).numel())
        nbytes = (n * (12 + 12 + 4) + n * 12 + nodes_bytes + 24 + aabb_blocks * 24 + g_slots * 18 * 4
                  + tri_slots * 9 * 4 + winners * 4)
        flops = (slots + mt_slots) * 33
        bound_ms, bound_by = bound(nbytes, flops)
        return dict(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, operations=flops, node_steps=node_steps,
                    blocks_tested=blocks, blocks_edge_tested=int(edge_blocks.sum()), slots_tested=slots,
                    distances=mt_slots, block_g_slots_read=g_slots, block_tris_slots_read=tri_slots,
                    block_aabbs_read=aabb_blocks)

    def kernel_entry(name, mode, kd, inputs, depth, launches, err, nodes_bytes, extra):
        """Time one warp walk at the main path's shapes, in turns with the
        per-ray walk it replaced, beside its plain version and its bound ->
        one entry of the ``kernels`` line.

        The bound (``work_bound``) counts what these rays need: the per-ray
        packet walk's counts, which has the per-block AABB pre-test that
        all three warp walks have (a warp visits the union of its rays'
        leaves, so it may do more).  For mega and forest the bound of
        their own per-ray walks' counts, which edge-test every block of
        every leaf they reach (no pre-test), is kept beside it as
        ``unpruned``.
        """
        any_hit = mode == "any_hit"
        ko, kdir, kt = inputs
        n = ko.shape[0]
        wrapper, plain, per_ray_walk = walks[name]
        turns = time_turns(torch, {"per_ray": lambda: per_ray_walk(kd, ko, kdir, kt, depth, any_hit),
                                   "warp": lambda: wrapper(kd, ko, kdir, kt, depth, any_hit)}, TIMING_REPS)
        ms = turns["warp"]
        plain_ms = wall_s(torch, lambda: plain(kd, ko, kdir, kt, depth, any_hit))[0] * 1e3
        work = work_bound(per_ray, kd, inputs, depth, any_hit, nodes_bytes)
        if name != "packet_traverse":
            work["unpruned"] = work_bound(per_ray_walk, kd, inputs, depth, any_hit, nodes_bytes)
        warp_stats = packet_stats(kd, inputs, depth, any_hit, wrapper)
        source, replaces = KERNELS[name]
        entry = dict(name=f"{name}[{mode}]", route="cuda", source=source, replaces=replaces,
                     launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=work.pop("bound_ms"), bound_by=work.pop("bound_by"), library_ms=None, rays=n,
                     per_ray_ms=turns["per_ray"], **work, warp_stats=warp_stats, **extra)
        unpruned = entry.get("unpruned")
        log(f"phase times {name}[{mode}]: {n} rays, warp walk {ms:.3f} ms/launch, per-ray walk "
            f"{turns['per_ray']:.3f} ms (plain {plain_ms:.1f} ms), bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}: {entry['bytes']} bytes, {entry['operations']} operations; per-ray packet "
            f"walk: {entry['node_steps']} node steps, {entry['blocks_tested']} blocks tested "
            f"({entry['blocks_edge_tested']} distinct of {kd.block_orig.shape[0]}), {entry['slots_tested']} "
            f"non-empty slots edge-tested, {entry['distances']} distances)"
            + (f"; unpruned bound {unpruned['bound_ms']:.4f} ms ({unpruned['bound_by']}: "
               f"{unpruned['slots_tested']} slots edge-tested, {unpruned['distances']} distances)" if unpruned else "")
            + f"; warp counts {json.dumps(warp_stats)}")
        return entry

    def bound(nbytes, flops):
        """(the least time in ms, what bounds it) of work that moves
        ``nbytes`` and does ``flops`` fp32 operations."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def binned_walk(kd, inputs, depth, any_hit):
        """One binned walk (device rounds) -> (its result, the (o, d, keys)
        of each block-loop launch it made, in order, keys copied: the walk
        reuses its key buffer).  The launches are seen where the walk makes
        them, ``binned._launch``."""
        launched = []
        launch = binned._launch

        def record(kd_, o_, d_, keys, mode, *rest):
            launched.append((o_, d_, keys.clone()))
            return launch(kd_, o_, d_, keys, mode, *rest)

        binned._launch = record
        try:
            out = binned.binned_traverse(kd, *inputs, depth, any_hit)
        finally:
            binned._launch = launch
        return out, launched

    def host_walk(kd, inputs, depth, any_hit, rounds=None):
        """The binned walk with host-driven rounds: traverse._walk's torch descend,
        driven from the host, with the block-loop kernel as its leaf stage
        on the rays that have a block; ``rounds`` counts its leaf calls."""
        mode = "any_hit" if any_hit else "closest"

        def leaf(kd_, o_, d_, keys):
            if rounds is not None:
                rounds.append(1)
            return binned._launch(kd_, o_, d_, keys, mode)

        return _walk(kd, *inputs, depth, any_hit, False, leaf)

    def host_reads(fn):
        """(the host syncs ``fn`` makes, by the source line that made them,
        its result): torch's sync debug mode warns once per synchronizing
        call (a .item(), a nonzero)."""
        import warnings

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                site = f"{os.path.basename(w.filename)}:{w.lineno}"
                sites[site] = sites.get(site, 0) + 1
        return sites, out

    def tile_walks(label, kd, inputs, depth, any_hit):
        """One tile's binned walk with device rounds and with host-driven
        rounds, timed in turns (device, host, host, device); both give the
        same bits.  -> {seconds of each, rounds, host syncs}."""
        mode = "any_hit" if any_hit else "closest"
        fns = {"device": lambda: binned.binned_traverse(kd, *inputs, depth, any_hit),
               "host": lambda: host_walk(kd, inputs, depth, any_hit)}
        secs = {"device": [], "host": []}
        for which in ("device", "host", "host", "device"):
            secs[which].append(wall_s(torch, fns[which])[0])
        reset_counts()
        dev_sites, out_d = host_reads(fns["device"])
        dev_syncs = sum(dev_sites.values())
        dev_rounds = binned.launches[mode]
        check(binned.descend_launches[mode] == dev_rounds, f"binned walk {label}: {binned.descend_launches} "
                                                           f"descend launches, {binned.launches} block-loop launches")
        host_rounds = []
        host_sites, out_h = host_reads(lambda: host_walk(kd, inputs, depth, any_hit, host_rounds))
        host_syncs = sum(host_sites.values())
        check(all(torch.equal(a, b) for a, b in zip(out_d, out_h)),
              f"binned walk {label} {mode}: device rounds and host-driven rounds differ")
        res = dict(device_s=secs["device"], host_s=secs["host"], device_rounds=dev_rounds,
                   device_host_syncs=dev_syncs, device_sync_sites=dev_sites, host_rounds=len(host_rounds),
                   host_host_syncs=host_syncs)
        log(f"phase times binned walk {label} {mode}, {inputs[0].shape[0]} rays, in turns: device rounds "
            f"{json.dumps(secs['device'])} s ({dev_rounds} rounds, {dev_syncs} host syncs: {json.dumps(dev_sites)}), "
            f"host-driven rounds "
            f"{json.dumps(secs['host'])} s ({len(host_rounds)} rounds, {host_syncs} host syncs); the same bits")
        return res

    def block_loop_entry(label, mode, kd, launched, tile_walk, launches, extra):
        """The block-loop kernel over the launches of one binned walk ->
        one entry of the ``kernels`` line: the mean time per launch (the
        walk's launches replayed, CUDA events, 20 times after 2 warm), in
        turns with the per-ray kernel it replaced; the plain version's time (``leaf_plain`` on the rays with a key in [0, B), in
        chunks of _PLAIN_CHUNK rays); the mean bound per launch; the
        distinct keys per warp and per CTA.  Each launch's outputs must
        equal the plain version's and the per-ray kernel's bit for bit, and
        be (inf, 2**30) where the key is outside [0, B).

        A launch's bound is the larger of its bytes over 3.35 TB/s (the
        key read, t and prim written, and o, d read once for each ray with
        a key in [0, B): the rays that have work; rows 0-5 of block_g's edge sections for the
        non-empty slots of the distinct blocks it names, 18 floats;
        block_tris of the slots whose distance was computed, 9 floats;
        block_orig of the distinct triangles returned) and its fp32
        operations over 67 TFLOP/s (33 per edge-sign test of a non-empty
        slot, 33 per distance), both counted by the kernel's
        measurement-only build.  ``bound_ms_whole_batch`` adds the key read
        and the t, prim writes of the launch's rays with no key, which the
        whole-batch launch makes and a compacted one would not."""
        count = len(launched)
        replay = lambda fn: (lambda: [fn(kd, *x) for x in launched])
        turns = time_turns(torch, {
            "staged": replay(lambda kd_, o_, d_, k_: binned._launch(kd_, o_, d_, k_, "closest")),
            "per_ray": replay(binned.block_loop_per_ray)}, TIMING_REPS)
        ms = {k: v / count for k, v in turns.items()}
        B, S = kd.block_orig.shape
        plain_s, err, rays, keyed, bounds, whole, totals = 0.0, 0.0, 0, 0, [], [], [0, 0, 0, 0]
        key_counts = torch.zeros((len(binned.KEY_COUNTS),), dtype=torch.int32, device=dev)
        for lo, ld, lk in launched:
            n = lo.shape[0]
            rays += n
            tk, pk = binned.block_loop_intersect(kd, lo, ld, lk)
            tr, pr = binned.block_loop_per_ray(kd, lo, ld, lk)
            check(torch.equal(tk, tr) and torch.equal(pk, pr), f"block_loop {label}: differs from the per-ray kernel")
            valid = (lk >= 0) & (lk < B)
            check(not bool(torch.isfinite(tk[~valid]).any()) and bool((pk[~valid] == 2**30).all()),
                  f"block_loop {label}: a ray without a key in [0, B) has a hit")
            idx = torch.nonzero(valid)[:, 0]
            keyed += idx.numel()
            for s0 in range(0, idx.numel(), _PLAIN_CHUNK):
                part = idx[s0:s0 + _PLAIN_CHUNK]
                sec, (tp, pp) = wall_s(torch, lambda: leaf_plain(kd, lo[part], ld[part], lk[part]))
                plain_s += sec
                hit = torch.isfinite(tp)
                check(torch.equal(tk[part], tp) and torch.equal(pk[part], pp),
                      f"block_loop {label}: {int((tk[part] != tp).sum())} t and {int((pk[part] != pp).sum())} "
                      f"prims differ from its plain version")
                if bool(hit.any()):
                    err = max(err, float((tk[part] - tp)[hit].abs().max()))
            stats = torch.zeros((n, 2), dtype=torch.int32, device=dev)
            touched = torch.zeros((B, 2 + S), dtype=torch.int32, device=dev)
            binned.block_loop_intersect(kd, lo, ld, lk, stats=stats, touched=touched, key_counts=key_counts)
            slots, distances = (int(x) for x in stats.sum(0, dtype=torch.int64))
            g_slots = int((kd.block_orig[touched[:, 1] > 0] >= 0).sum())
            tri_slots = int(touched[:, 2:].sum(dtype=torch.int64))
            winners = int(torch.unique(pk[torch.isfinite(tk)]).numel())
            nbytes = idx.numel() * (4 + 8 + 24) + g_slots * 18 * 4 + tri_slots * 9 * 4 + winners * 4
            bounds.append(bound(nbytes, (slots + distances) * 33))
            whole.append(bound(nbytes + (n - idx.numel()) * (4 + 8), (slots + distances) * 33)[0])
            for i, v in enumerate((nbytes, slots, distances, g_slots)):
                totals[i] += v
        kc = dict(zip(binned.KEY_COUNTS, key_counts.tolist()))
        kc["keys_per_warp"] = kc["warp_keys"] / max(kc["warps"], 1)
        kc["keys_per_cta"] = kc["cta_keys"] / max(kc["ctas"], 1)
        by_bytes = sum(1 for _, by in bounds if by == "bytes")
        source, replaces = KERNELS["block_loop"]
        entry = dict(name=f"block_loop[{mode}{label}]", route="cuda", source=source, replaces=replaces,
                     launches=launches, max_abs_err=err, ms=ms["staged"],
                     plain_ms=plain_s * 1e3 / count, bound_ms=sum(b for b, _ in bounds) / count,
                     bound_by="bytes" if by_bytes * 2 > count else "operations", library_ms=None,
                     bound_ms_whole_batch=sum(whole) / count, per_ray_ms=ms["per_ray"], walk_launches=count,
                     tile_walk=tile_walk, rays_per_launch=rays / count, keyed_rays_per_launch=keyed / count,
                     bytes=totals[0], operations=(totals[1] + totals[2]) * 33, slots_tested=totals[1],
                     distances=totals[2], block_g_slots_read=totals[3], key_counts=kc, **extra)
        log(f"phase times block_loop[{mode}{label}]: {count} launches of a walk, {rays / count:.0f} rays each "
            f"({keyed / count:.0f} with a key) on average; in turns {ms['staged']:.4f} ms/launch, per-ray kernel "
            f"{ms['per_ray']:.4f} ms (plain {entry['plain_ms']:.2f} ms), "
            f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}: {totals[0]} bytes, {entry['operations']} "
            f"operations in all; {by_bytes} of {count} launches bound by bytes; with the whole batch's key reads "
            f"and t, prim writes {entry['bound_ms_whole_batch']:.5f} ms), {totals[1]} non-empty slots edge-tested, "
            f"{totals[2]} distances; distinct keys "
            f"{json.dumps(kc)}; equal to its plain version and the per-ray kernel on every launch")
        return entry

    def descend_entry(label, mode, kd, inputs, depth, launches, extra):
        """The round kernel over one tile's binned walk -> one entry of the
        ``kernels`` line: CUDA events around each of its launches in the
        walk, the mean; the plain version's mean per round (the same walk
        with ``descend_plain`` as its descend, on the card, host clock, the
        same bits); and the mean bound per launch, bytes over 3.35 TB/s:
        each ray's active flag read and key written, and per ray active at
        the round's start its rays, interval, stack depth, cursor, best
        hit, clip and last leaf result read (68 bytes) and its state
        written (36 bytes), and the node table read."""
        any_hit = mode == "any_hit"
        n = inputs[0].shape[0]
        events, actives = [], []
        descend = binned.descend

        def timed(*args):
            actives.append(args[6].active.sum())
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            descend(*args)
            e1.record()
            events.append((e0, e1))

        plain_s = []

        def plain(*args):
            t0 = time.perf_counter()
            binned.descend_plain(*args)
            torch.cuda.synchronize()
            plain_s.append(time.perf_counter() - t0)

        outs = {}
        for name, fn in (("kernel", timed), ("plain", plain)):
            binned.descend = fn
            try:
                outs[name] = binned.binned_traverse(kd, *inputs, depth, any_hit)
            finally:
                binned.descend = descend
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(outs["kernel"], outs["plain"])),
              f"binned_descend {label} {mode}: the walk differs with the plain round")
        ms = sum(a.elapsed_time(b) for a, b in events) / len(events)
        act = [int(a) for a in actives]
        nodes_bytes = kd.node_flag.shape[0] * 20
        bounds = [(n * 8 + a * (68 + 36) + nodes_bytes) / HBM_BYTES_PER_S * 1e3 for a in act]
        source, replaces = KERNELS["binned_descend"]
        entry = dict(name=f"binned_descend[{mode}{label}]", route="cuda", source=source, replaces=replaces,
                     launches=launches, max_abs_err=0.0, ms=ms, plain_ms=sum(plain_s) * 1e3 / len(plain_s),
                     bound_ms=sum(bounds) / len(bounds), bound_by="bytes", library_ms=None, rays=n,
                     walk_launches=len(events), active_at_round_start=act, **extra)
        log(f"phase times binned_descend[{mode}{label}]: {len(events)} launches on {n} rays, {ms:.4f} ms/launch "
            f"(plain {entry['plain_ms']:.2f} ms a round), bound {entry['bound_ms']:.5f} ms (bytes), active rays at "
            f"the rounds' starts {act[:4]}...{act[-2:]}; the walk with the plain round gives the same bits")
        return entry

    # ---- 5. teapot parity: packet, per-ray, mega (warp and per-ray) and binned ----
    depth = _stack_depth(kd, cfg)
    verts = scene.triangles.verts
    edge_rows[verts.data_ptr()] = block_edge_rows(kd, verts.shape[0])  # the very bits the kernels test
    plains = {"plain": traverse_plain}
    o_all, d_all, raw_all, tile, start = best_window(scene, cfg, per_ray, depth)
    o, d, raw = (x[start:start + tile] for x in (o_all, d_all, raw_all))
    log(f"phase 5 parity tile: rays [{start}, {start + tile}) of {o_all.shape[0]}")
    parity = {k: {} for k in ("packet_traverse", "packet_traverse_per_ray", "mega_walk", "mega_walk_per_ray",
                              "block_loop")}
    timing_inputs = {}
    for k, (qo, qd, qt), (so, sd, st) in bounces(scene, cfg, o, d, raw, (0, LATER_BOUNCE), tile):
        refs, raws = closest_refs(kd, verts, depth, qo, qd, qt, plains, qo.shape[0])
        pr = per_ray(kd, qo, qd, qt, depth, False)
        parity["packet_traverse_per_ray"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "packet_traverse_per_ray", pr, refs, verts, qo, qd, qt)
        mpr = mega.mega_traverse_per_ray(kd, qo, qd, qt, depth, False)
        refs["per_ray"] = (*pr[:2], pr[2] & (pr[0] < qt), qo.shape[0])
        parity["mega_walk_per_ray"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "mega_walk_per_ray", mpr, refs, verts, qo, qd, qt)
        pk = packet_walk(kd, qo, qd, qt, depth, False)
        for kname, out, others in (("packet_traverse", pk, dict(raws, per_ray=pr)),
                                   ("mega_walk", mega.mega_traverse(kd, qo, qd, qt, depth, False),
                                    dict(raws, per_ray=pr, mega_per_ray=mpr, packet_traverse=pk))):
            parity[kname][f"closest_b{k}"] = check_warp(f"bounce {k}", kname, kd, out, others, qo, qd)
            parity[kname][f"closest_b{k}"].update(check_closest(
                f"bounce {k}", kname, out, {"brute": refs["brute"]}, verts, qo, qd, qt))
        parity["block_loop"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "binned walk", binned.binned_traverse(kd, qo, qd, qt, depth, False), refs, verts,
            qo, qd, qt)
        if k == 0:
            timing_inputs["closest"] = (qo, qd, qt)
            timing_inputs["any_hit"] = (so, sd, st)
        # the shadow rays of the first SHADOW_POINTS hit points, per light
        n_sub = min(SHADOW_POINTS, tile)
        sel = torch.cat([torch.arange(li * tile, li * tile + n_sub, device=dev)
                         for li in range(scene.lights.position.shape[0])])
        so, sd, st = so[sel].contiguous(), sd[sel].contiguous(), st[sel].contiguous()
        aplain = traverse_plain(kd, so, sd, st, depth, True)
        arefs = {"plain": (*aplain[1:], so.shape[0]),
                 "brute": (None, brute_any(verts, so, sd, st), so.shape[0])}
        pr = per_ray(kd, so, sd, st, depth, True)
        parity["packet_traverse_per_ray"][f"any_b{k}"] = check_any(
            f"bounce {k}", "packet_traverse_per_ray", pr, arefs, verts, so, sd, st)
        arefs["per_ray"] = (*pr[1:], so.shape[0])
        for kname, walk in (("mega_walk_per_ray", mega.mega_traverse_per_ray), ("packet_traverse", packet_walk),
                            ("mega_walk", mega.mega_traverse)):
            parity[kname][f"any_b{k}"] = check_any(f"bounce {k}", kname, walk(kd, so, sd, st, depth, True), arefs,
                                                   verts, so, sd, st)
        bk = binned.binned_traverse(kd, so, sd, st, depth, True)
        parity["block_loop"][f"any_b{k}"] = check_any(f"bounce {k}", "binned walk", bk, arefs, verts, so, sd, st)
        check_any_t_prim(f"bounce {k}", bk, {"plain": aplain})
    log("phase 5 parity done")

    # ---- 6. teapot kernel times and bounds ----
    kernels = []
    M = kd.node_flag.shape[0]
    for name, nodes_bytes in (("packet_traverse", M * 20), ("mega_walk", M * 24)):
        for mode in ("closest", "any_hit"):
            par = parity[name]
            key = "closest" if mode == "closest" else "any"
            launches = counts[mode] if name == "packet_traverse" else None  # mega: phase 7
            kernels.append(kernel_entry(
                name, mode, kd, timing_inputs[mode], depth, launches, plain_err(par, mode, plains),
                nodes_bytes, dict(scene="teapot", parity={"bounce0": par[f"{key}_b0"],
                                             f"bounce{LATER_BOUNCE}": par[f"{key}_b{LATER_BOUNCE}"]})))
    kernels.append(families_entry(scene, cfg, o_all, d_all, raw_all, family_launches["teapot frame"]))
    kernels.append(families_closest_phase(torch, dev, scene))
    attach_bounces(kernels, per_bounce("teapot", scene, cfg, o, d, raw, "mega_walk"), "mega_walk")
    log("phase 6 teapot kernel times")

    # ---- 7. the teapot frame through the mega kernel ----
    mcfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0,
                       traversal_backend="mega")
    mega_sort = _sort_bounces(scene, mcfg, dev)
    wall_s(torch, lambda: render_image(scene, mcfg, device=dev))
    mega_s, mega_img, mega_counts = frame(scene, mcfg, "teapot mega frame", "mega_walk")
    mega_off = u8_off(quantize_u8, mega_img, img_pr)
    check(mega_off < U8_TOLERANCE, f"mega teapot frame: {mega_off:.4%} of u8 channels off by > 1")
    mega_sorts = sort_samples(scene, mcfg)
    for e in kernels:
        if e["name"].startswith("mega_walk"):
            e["launches"] = mega_counts[e["name"].split("[")[1][:-1]]
            e["frame_s"], e["frame_sorts"] = mega_s, mega_sorts
    log(f"phase 7 mega frame (sort_bounces={mega_sort} by default): {mega_s:.3f} s "
        f"({mega_s / frame_s:.3f} x the packet frame's {frame_s:.3f} s), launches {mega_counts}, vs per-ray "
        f"frame: {mega_off:.6%} of u8 channels off by > 1, max abs diff {float((mega_img - img_pr).abs().max()):.3g}; "
        f"seconds with sort_bounces on and off, in turns: {json.dumps(mega_sorts)}")
    del mega_img

    # ---- 8. the teapot frame through the binned walk (block-loop kernel) ----
    bcfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0,
                       traversal_backend="binned")
    binned_s, binned_img, binned_counts = frame(scene, bcfg, "teapot binned frame", BINNED)
    binned_off = u8_off(quantize_u8, binned_img, img_pr)
    check(binned_off == 0.0, f"binned teapot frame: {binned_off:.4%} of u8 channels off by > 1 "
                             "from the per-ray frame (the same leaf test and visit order: none may be)")
    log(f"phase 8 binned frame (full 1920x1080, not cut): {binned_s:.3f} s, launches per frame {binned_counts}, "
        f"vs per-ray frame: {binned_off:.6%} of u8 channels off by > 1, "
        f"max abs diff {float((binned_img - img_pr).abs().max()):.3g}; vs packet frame: "
        f"{u8_off(quantize_u8, binned_img, img):.6%}")
    del img, img_pr, binned_img
    for mode in ("closest", "any_hit"):
        key = "closest" if mode == "closest" else "any"
        tw = tile_walks("teapot", kd, timing_inputs[mode], depth, mode == "any_hit")
        _, launched = binned_walk(kd, timing_inputs[mode], depth, mode == "any_hit")
        par = parity["block_loop"]
        kernels.append(block_loop_entry("", mode, kd, launched, tw, binned_counts["block_loop"][mode], dict(
            scene="teapot", frame_s=binned_s, parity={"bounce0": par[f"{key}_b0"],
                                                      f"bounce{LATER_BOUNCE}": par[f"{key}_b{LATER_BOUNCE}"]})))
        del launched
        kernels.append(descend_entry("", mode, kd, timing_inputs[mode], depth,
                                     binned_counts["binned_descend"][mode], dict(scene="teapot", frame_s=binned_s)))
    log("phase 8 block-loop and round kernel times")

    # ---- 9. brute force: the Möller–Trumbore and Plücker kernels ----
    o_f, d_f, _, n_f, _ = frame_rays(cfg, dev)
    o_f, d_f = o_f[:n_f].contiguous(), d_f[:n_f].contiguous()
    n_tri = verts.shape[0]
    soa, gpk = mt.swizzle_tris(verts), plucker.plucker_pack(verts)
    bo, bd = (x[start:start + BRUTE_PARITY_RAYS].contiguous() for x in (o_all, d_all))
    # the 480x270 frame's launch shape: its first ray tile of primary rays
    lcfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, **BRUTE_FRAME)
    o_l, d_l, _, _, l_tile = frame_rays(lcfg, dev)
    o_l, d_l = o_l[:l_tile].contiguous(), d_l[:l_tile].contiguous()
    brute_entries = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the cross-split tie case: the teapot twice, the copy 6,400 triangles on
    # (12,800 columns: 2 or 4 splits put every copy in another split)
    tie_verts = torch.cat([verts, torch.zeros((6400 - n_tri, 3, 3), device=dev), verts])

    def same(out, ref):
        return torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])

    def exit_counts(module, wrapper, packed, o, d, ref):
        """The stats build's counts on these rays (its bits checked too)."""
        stats = torch.zeros((len(brute.STATS_ROWS), len(module.EXITS)), dtype=torch.int64, device=dev)
        check(same(wrapper(packed, o, d, stats=stats), ref), f"{module.NAME}: the stats build differs")
        return {row: dict(zip(module.EXITS, vals)) for row, vals in zip(brute.STATS_ROWS, stats.tolist())}

    for name, module, wrapper, per_ray_k, plain, pack, packed, ops in (
            ("mt_closest", mt, mt.mt_closest, mt.mt_closest_per_ray, mt.mt_closest_plain, mt.swizzle_tris, soa,
             MT_OPS),
            ("plucker_closest", plucker, plucker.plucker_closest, plucker.plucker_closest_per_ray,
             plucker.plucker_closest_plain, plucker.plucker_pack, gpk, PLUCKER_OPS)):
        t_total = packed.shape[-1]
        tk, ik = wrapper(packed, o_f, d_f)
        check(same(per_ray_k(packed, o_f, d_f), (tk, ik)), f"{name}: differs from the per-ray kernel on {n_f} rays")
        turns = time_turns(torch, {"new": lambda: wrapper(packed, o_f, d_f),
                                   "per_ray": lambda: per_ray_k(packed, o_f, d_f)}, TIMING_REPS)
        ms = turns["new"]
        plain_s, err, hits = 0.0, 0.0, 0
        for s0 in range(0, n_f, BRUTE_PARITY_RAYS):  # the plain version on every ray, in chunks
            part = slice(s0, s0 + BRUTE_PARITY_RAYS)
            sec, (tp, ip) = wall_s(torch, lambda: plain(packed, o_f[part], d_f[part]))
            plain_s += sec
            check(torch.equal(tk[part], tp) and torch.equal(ik[part], ip),
                  f"{name}: rays [{s0}, {s0 + BRUTE_PARITY_RAYS}) differ from its plain version: "
                  f"{int((tk[part] != tp).sum())} t, {int((ik[part] != ip).sum())} indices")
            hit = torch.isfinite(tp)
            hits += int(hit.sum())
            if bool(hit.any()):
                err = max(err, float((tk[part] - tp)[hit].abs().max()))
        b_ms, b_by = bound(packed.numel() * 4 + n_f * (24 + 8), ops * n_f * n_tri)
        full_splits = brute.splits(n_f, t_total, sms)
        full_exits = exit_counts(module, wrapper, packed, o_f, d_f, (tk, ik))
        # one launch of the 480x270 frame: 16,384 rays, timed in turns with the per-ray kernel
        tl, il = wrapper(packed, o_l, d_l)
        check(same((tl, il), plain(packed, o_l, d_l)) and same(per_ray_k(packed, o_l, d_l), (tl, il)),
              f"{name}: the 480x270 launch differs from its plain version or the per-ray kernel")
        l_turns = time_turns(torch, {"new": lambda: wrapper(packed, o_l, d_l),
                                     "per_ray": lambda: per_ray_k(packed, o_l, d_l)}, TIMING_REPS)
        l_ms = l_turns["new"]
        lb_ms, lb_by = bound(packed.numel() * 4 + l_tile * (24 + 8), ops * l_tile * n_tri)
        rule = brute.splits(l_tile, t_total, sms)
        ray_ctas = -(-l_tile // brute.RAYS_PER_CTA)
        by_splits = {}
        for c in sorted({1, 2, 4, 8, 16, 26, t_total // brute.TILE, rule}):
            check(same(wrapper(packed, o_l, d_l, splits=c), (tl, il)), f"{name}: {c} splits differ")
            by_splits[c] = time_ms(torch, lambda: wrapper(packed, o_l, d_l, splits=c), TIMING_REPS)
        l_exits = exit_counts(module, wrapper, packed, o_l, d_l, (tl, il))
        # the tie case on the card: the originals win every tie across a split boundary
        tie = pack(tie_verts)
        to, td = bo[:l_tile], bd[:l_tile]  # rays of the parity tile, which hit the teapot most
        tie_ref = plain(tie, to, td)
        tie_hit = torch.isfinite(tie_ref[0])
        check(int(tie_hit.sum()) > l_tile // 8 and bool((tie_ref[1][tie_hit] < 6400).all()),
              f"{name}: the tie case has {int(tie_hit.sum())} hits, or a copy won a tie")
        for c in (None, 2, 4):
            check(same(wrapper(tie, to, td, splits=c), tie_ref), f"{name}: the tie case differs at {c} splits")
        launch_shape = dict(rays=l_tile, triangles=n_tri, ms=l_ms, per_ray_ms=l_turns["per_ray"], bound_ms=lb_ms,
                            bound_by=lb_by, splits=rule, ctas=ray_ctas * rule, sms=sms, ms_by_splits=by_splits,
                            exits=l_exits)
        log(f"phase 9 {name} at the 480x270 frame's launch shape: {l_tile} rays x {n_tri} triangles, in turns "
            f"{l_ms:.4f} ms/launch (per-ray kernel {l_turns['per_ray']:.4f} ms), bound {lb_ms:.4f} ms ({lb_by}); "
            f"{rule} splits ({ray_ctas} ray tiles x {rule} = {ray_ctas * rule} CTAs on {sms} SMs); ms by splits "
            f"{json.dumps(by_splits)}; exits {json.dumps(l_exits)}; equal to its plain version and the per-ray "
            f"kernel, and on the tie case ({l_tile} rays of the parity tile, {int(tie_hit.sum())} hits, "
            f"{tie.shape[-1]} columns) at 2, 4 and {brute.splits(l_tile, tie.shape[-1], sms)} splits")
        source, replaces = KERNELS[name]
        brute_entries[name] = dict(
            name=f"{name}[closest]", route="cuda", source=source, replaces=replaces, launches=None,
            max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            per_ray_ms=turns["per_ray"], rays=n_f, triangles=n_tri, pairs=n_f * n_tri, operations=ops * n_f * n_tri,
            hits=hits, splits=full_splits, ctas=-(-n_f // brute.RAYS_PER_CTA) * full_splits, exits=full_exits,
            scene="teapot, 1080p primary rays", launch_shape=launch_shape)
        log(f"phase 9 {name}: {n_f} rays x {n_tri} triangles, in turns {ms:.3f} ms/launch (per-ray kernel "
            f"{turns['per_ray']:.3f} ms; plain {plain_s * 1e3:.1f} ms in {BRUTE_PARITY_RAYS}-ray chunks), bound "
            f"{b_ms:.4f} ms ({b_by}), {full_splits} split(s), {hits} hits, exits {json.dumps(full_exits)}; equal to "
            f"its plain version and the per-ray kernel on all {n_f} rays")
        del tk, ik, tie
    # the Plücker kernel against brute force (tests/test_pallas.py's rule, ties excused), and on every
    # ray where the two differ, against the edge-sign brute force on its own packed edge rows
    tp, ip = plucker.plucker_closest(gpk, bo, bd)
    tb, ib = brute_force_closest(verts, bo, bd)
    hp, hb = torch.isfinite(tp), torch.isfinite(tb)
    both = hp & hb
    flip = both & (ip != ib)
    tie = torch.zeros_like(flip)
    if bool(flip.any()):
        tie[flip] = (mt_t_of(verts, ip[flip], bo[flip], bd[flip]) - mt_t_of(verts, ib[flip], bo[flip], bd[flip])
                     ).abs() <= TIE_RTOL * tb[flip].abs()
    differ = (hp != hb) | (flip & ~tie)
    edge = differ & at_edge(verts, bo, bd, differ & hp, ip, differ & hb, ib)
    t_bad = both & ~flip & ((tp - tb).abs() > PLUCKER_T_RTOL * tb.abs())
    sel = (hp != hb) | flip
    es = dict(rays=int(sel.sum()), hits=0, mask_mismatch=0, prim_flips=0, ties=0, untied=0, t_out_of_rtol=0)
    if es["rays"]:
        so_, sd_ = bo[sel], bd[sel]
        te, ie = edge_sign_brute_closest(verts, so_, sd_, g=gpk[:3, :6, :n_tri].permute(1, 0, 2)[None])
        he, hps = torch.isfinite(te), hp[sel]
        eboth = hps & he
        eflip = eboth & (ip[sel] != ie)
        etie = torch.zeros_like(eflip)
        if bool(eflip.any()):  # both triangles' Möller–Trumbore t, bit-equal
            etie[eflip] = mt_t_exact(verts, ip[sel][eflip], so_[eflip], sd_[eflip]) == te[eflip]
        es.update(hits=int(he.sum()), mask_mismatch=int((hps != he).sum()), prim_flips=int(eflip.sum()),
                  ties=int(etie.sum()), untied=int((eflip & ~etie).sum()),
                  t_out_of_rtol=int((eboth & ~eflip & ((tp[sel] - te).abs() > PLUCKER_T_RTOL * te.abs())).sum()))
    pres = dict(rays=BRUTE_PARITY_RAYS, hits=int(hb.sum()), mask_mismatch=int((hp != hb).sum()),
                prim_flips=int(flip.sum()), ties=int(tie.sum()), at_edge=int(edge.sum()),
                unexplained=int((differ & ~edge).sum()), t_out_of_rtol=int(t_bad.sum()),
                max_rel_t_err=float(((tp - tb).abs() / tb.abs())[both & ~flip].max()) if bool(both.any()) else 0.0,
                edge_sign=es)
    check(es["mask_mismatch"] == 0 and es["untied"] == 0 and es["t_out_of_rtol"] == 0 and pres["unexplained"] == 0
          and pres["t_out_of_rtol"] == 0, f"plucker_closest vs brute force: {pres}")
    brute_entries["plucker_closest"]["parity_vs_brute_force"] = pres
    log(f"phase 9 plucker_closest vs brute force on {BRUTE_PARITY_RAYS} rays of the parity tile: {json.dumps(pres)}")
    # what a tensor-core design of the Plücker kernel has to beat: the fp32
    # product (N, 16) @ (16, 5 T') alone, TF32 off, in chunks of rays
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = plucker.swizzle_rays_plucker(o_f, d_f, 1)[0]
    g16 = torch.nn.functional.pad(gpk.permute(1, 0, 2).reshape(10, -1), (0, 0, 0, 6)).contiguous()
    prod = torch.empty((BRUTE_PARITY_RAYS, g16.shape[1]), device=dev)

    def matmul_all():
        for s0 in range(0, n_f, BRUTE_PARITY_RAYS):
            r = rows[s0:s0 + BRUTE_PARITY_RAYS]
            torch.matmul(r, g16, out=prod[:r.shape[0]])

    mm_ms = time_ms(torch, matmul_all, 5)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    brute_entries["plucker_closest"]["fp32_matmul_ms"] = mm_ms
    log(f"phase 9 fp32 torch.matmul ({n_f}, 16) @ (16, {g16.shape[1]}) in {BRUTE_PARITY_RAYS}-row chunks, TF32 off: "
        f"{mm_ms:.3f} ms, beside the Plücker kernel's {brute_entries['plucker_closest']['ms']:.3f} ms")
    del rows, prod, o_f, d_f
    # the 480x270 teapot frame through each brute-force path, and the packet frame
    bc = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, **BRUTE_FRAME)
    bscene = default_scene(seed=0, cfg=bc, mesh="teapot").build(bc, device=dev)
    bframes = {}
    for backend, only in (("jnp", None), ("pallas", "mt_closest"), ("plucker", "plucker_closest")):
        bc = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48,
                         triangle_backend=backend, **BRUTE_FRAME)
        bframes[backend] = frame(bscene, bc, f"480x270 brute-force frame ({backend})", only, ("closest",))
        if only:
            brute_entries[only]["launches"] = bframes[backend][2]["closest"]
    pc = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48,
                     **{k: v for k, v in BRUTE_FRAME.items() if k != "brute_threshold"})
    # the packet walk's frame and the per-ray walk's, in turns (packet, per-ray, per-ray, packet)
    first_s, bpk_img, bpk_counts = frame(bscene, pc, "480x270 packet frame", "packet_traverse")
    bpk_s = [first_s]
    with frame_walk(per_ray):
        bpr_s = [frame(bscene, pc, "480x270 per-ray frame", "packet_traverse_per_ray")[0]]
        bpr_s.append(wall_s(torch, lambda: render_image(bscene, pc, device=dev))[0])
        bpr_img = render_image(bscene, pc, device=dev)
    bpk_s.append(wall_s(torch, lambda: render_image(bscene, pc, device=dev))[0])
    check(torch.equal(bframes["pallas"][1], bframes["jnp"][1]),
          "480x270: the 'pallas' frame differs from the 'jnp' frame")
    offs = {b: u8_off(quantize_u8, bframes[b][1], bpk_img) for b in ("pallas", "plucker")}
    offs["per_ray"] = u8_off(quantize_u8, bpr_img, bpk_img)
    check(all(v < U8_TOLERANCE for v in offs.values()), f"480x270 frames vs packet frame: {offs}")
    shares = {name: brute_entries[name]["launches"] * brute_entries[name]["launch_shape"]["ms"]
              / (bframes[b][0] * 1e3) for b, name in (("pallas", "mt_closest"), ("plucker", "plucker_closest"))}
    for name, share in shares.items():
        brute_entries[name]["share_of_frame"] = share
    log("phase 9 480x270 frames, 10 bounces, brute_threshold=6320: "
        + ", ".join(f"{b} {bframes[b][0]:.3f} s (launches {bframes[b][2]})" for b in bframes)
        + f"; the kernels' share of their frames (launches x ms per launch / frame): {json.dumps(shares)}"
        + f"; without brute_threshold, in turns: packet walk {json.dumps(bpk_s)} s (launches {bpk_counts}), "
        f"per-ray walk {json.dumps(bpr_s)} s; 'pallas' equals 'jnp' bit for bit; "
        f"u8 channels off by > 1 from the packet frame: {offs}")
    kernels += list(brute_entries.values())
    del bframes, bpk_img, bpr_img, bscene

    # ---- 10. the flagship scene: bench.py's dragon ----
    fcfg = Config(**FLAGSHIP)
    t = time.perf_counter()
    builder = default_scene(seed=0, cfg=fcfg, mesh="dragon")
    load_s = time.perf_counter() - t
    build_s, dscene = wall_s(torch, lambda: builder.build(fcfg, device=dev))
    dkd = dscene.kd
    check(dkd.tre_tbl is not None and dkd.top_tbl is not None, "dragon tree has no treelet tables")
    dM = dkd.node_flag.shape[0]
    dB, dS = dkd.block_orig.shape
    log(f"phase 10 dragon scene: {dscene.n_triangles} triangles, load {load_s:.2f} s, host build + upload "
        f"{build_s:.2f} s, {dM} nodes ({int((dkd.node_flag == 3).sum())} leaves), depth {dkd.max_depth}, "
        f"{dB} blocks of {dS} slots ({float((dkd.block_orig >= 0).float().mean()):.1%} of slots hold a triangle), "
        f"{dkd.tre_tbl.shape[0]} treelets of {dkd.tre_tbl.shape[1]} rows, {dkd.top_tbl.shape[0]} top rows, "
        f"block_g {dkd.block_g.numel() * 4 / 1e6:.1f} MB")

    # ---- 11. the flagship frame (auto: packet walk) ----
    sort_default = _sort_bounces(dscene, fcfg, dev)
    flag_frames = frame_set(dscene, fcfg, "dragon flagship frame", {
        "per_ray": ({}, per_ray),
        "sort_shadow=False": ({"sort_shadow": False}, packet_walk),
        f"sort_bounces={not sort_default}": ({"sort_bounces": not sort_default}, packet_walk)})
    flag_sorts = sort_samples(dscene, fcfg)
    log(f"phase 11 flagship frame seconds with sort_bounces on and off, in turns: {json.dumps(flag_sorts)}")
    flag_s, flag_counts = flag_frames[0]["default"], flag_frames[2]["default"]
    flag_img, flag_img_pr = flag_frames[3], flag_frames[4]
    flag_ref = flag_img  # phase 11's frame, held by phases 20, 21 and 23
    log(f"phase 11 flagship frames (sort_bounces={sort_default} by default, sort_shadow="
        f"{_sort_shadow(dscene, fcfg)}): seconds {json.dumps(flag_frames[0])}, u8 channels off by > 1 from "
        f"the default frame {json.dumps(flag_frames[1])}, launches {json.dumps(flag_frames[2])}; "
        f"{pixels / flag_s:.0f} primary rays/s, mean {float(flag_img.mean()):.4f}")

    # ---- 12. the flagship frame through the forest kernel ----
    ffcfg = Config(**FLAGSHIP, traversal_backend="forest")
    forest_sort = _sort_bounces(dscene, ffcfg, dev)
    wall_s(torch, lambda: render_image(dscene, ffcfg, device=dev))
    forest_s, forest_img, forest_counts = frame(dscene, ffcfg, "dragon forest frame", "forest_walk")
    forest_off = u8_off(quantize_u8, forest_img, flag_img_pr)
    check(forest_off < U8_TOLERANCE, f"forest dragon frame: {forest_off:.4%} of u8 channels off by > 1")
    forest_sorts = sort_samples(dscene, ffcfg)
    log(f"phase 12 forest frame (full 1920x1080, not cut; sort_bounces={forest_sort} by default): {forest_s:.3f} s "
        f"({forest_s / flag_s:.3f} x the packet flagship frame's {flag_s:.3f} s), launches {forest_counts}, "
        f"vs the per-ray flagship frame: {forest_off:.6%} of u8 channels off by > 1, "
        f"max abs diff {float((forest_img - flag_img_pr).abs().max()):.3g}; seconds with sort_bounces on and off, "
        f"in turns: {json.dumps(forest_sorts)}")
    del forest_img

    # ---- 13. the flagship frame through "mega", which resolves to the binned walk ----
    bmcfg = Config(Width=1920, Height=1080, use_kdtree=True, ray_tile=0, MaxPrims=192, leaf_chunk_lanes=48,
                   traversal_backend="mega")
    resolved = _backend(dkd, bmcfg)
    check(resolved == "binned", f"traversal_backend='mega' on {dM} nodes resolved to {resolved!r}, not 'binned'")
    dbin_s, dbin_img, dbin_counts = frame(dscene, bmcfg, "dragon binned frame", BINNED)
    dbin_off = u8_off(quantize_u8, dbin_img, flag_img_pr)
    check(dbin_off == 0.0, f"binned dragon frame: {dbin_off:.4%} of u8 channels off by > 1 from the per-ray "
                           "frame (the same leaf test and visit order: none may be)")
    log(f"phase 13 traversal_backend='mega' on the dragon tree ({dM} nodes > 1024) resolves to {resolved!r}; "
        f"binned frame (full 1920x1080, not cut): {dbin_s:.3f} s, launches per frame {dbin_counts}, "
        f"vs the per-ray flagship frame: {dbin_off:.6%} of u8 channels off by > 1, "
        f"max abs diff {float((dbin_img - flag_img_pr).abs().max()):.3g}")
    del dbin_img, flag_img, flag_img_pr
    binned_sorts = None
    if dbin_s < BINNED_SORT_LIMIT:  # both binned frames with sort_bounces on and off, in turns
        binned_sorts = {"teapot": sort_samples(scene, bcfg), "dragon": sort_samples(dscene, bmcfg)}
        for e in kernels:
            if e["name"].startswith(("block_loop[", "binned_descend[")):
                e["frame_sorts"] = binned_sorts["teapot"]
    log(f"phase 13 binned frame seconds with sort_bounces on and off, in turns (sort_bounces="
        f"{_sort_bounces(dscene, bmcfg, dev)} by default): "
        + (json.dumps(binned_sorts) if binned_sorts else f"not timed: the frame took {BINNED_SORT_LIMIT} s or more"))

    # ---- 14. forest and binned parity on the dragon ----
    ddepth = _stack_depth(dkd, fcfg)
    dverts = dscene.triangles.verts
    edge_rows[dverts.data_ptr()] = block_edge_rows(dkd, dverts.shape[0])
    dplains = {"forest_plain": traverse_forest_plain, "plain": traverse_plain}
    o_all, d_all, raw_all, dtile, wstart = best_window(dscene, fcfg, per_ray, ddepth, DRAGON_PARITY_RAYS)
    w = slice(wstart, wstart + DRAGON_PARITY_RAYS)
    log(f"phase 14 parity window: rays [{wstart}, {wstart + DRAGON_PARITY_RAYS}) of {o_all.shape[0]}, "
        f"in the {dtile}-ray tile at {wstart // dtile * dtile}")
    dpar = {k: {} for k in ("packet_traverse", "packet_traverse_per_ray", "forest_walk", "forest_walk_per_ray",
                            "block_loop")}
    dsoa = mt.swizzle_tris(dverts)

    dragon_brute = {}

    def mt_brute(verts, o, d):
        """Closest-hit brute force by the Möller–Trumbore kernel, held first
        to the torch brute force on DRAGON_BRUTE_RAYS of the rays, bit for
        bit; the first time, timed once against the per-ray kernel it
        replaced (equal bits)."""
        sec, (tk, ik) = wall_s(torch, lambda: mt.mt_closest(dsoa, o, d))
        tb, ib = brute_closest(verts, o[:DRAGON_BRUTE_RAYS], d[:DRAGON_BRUTE_RAYS])
        check(torch.equal(tk[:DRAGON_BRUTE_RAYS], tb) and torch.equal(ik[:DRAGON_BRUTE_RAYS], ib),
              "mt_closest on the dragon differs from the torch brute force")
        timed = ""
        if not dragon_brute:
            per_s, per_out = wall_s(torch, lambda: mt.mt_closest_per_ray(dsoa, o, d))
            check(torch.equal(per_out[0], tk) and torch.equal(per_out[1], ik),
                  "mt_closest on the dragon differs from the per-ray kernel")
            rule = brute.splits(o.shape[0], dsoa.shape[-1], sms)
            by_splits = {}
            for c in sorted({2, 4, 8, 16, 32, rule}):
                c_s, out = wall_s(torch, lambda: mt.mt_closest(dsoa, o, d, splits=c))
                check(torch.equal(out[0], tk) and torch.equal(out[1], ik), f"mt_closest on the dragon: {c} splits differ")
                by_splits[c] = c_s * 1e3
            dragon_brute.update(rays=o.shape[0], triangles=verts.shape[0], ms=sec * 1e3, per_ray_ms=per_s * 1e3,
                                splits=rule, ms_by_splits=by_splits)
            timed = (f"; timed once: {sec * 1e3:.2f} ms ({rule} splits), per-ray kernel {per_s * 1e3:.2f} ms, equal "
                     f"bits; ms by splits, once each: {json.dumps(by_splits)}")
        log(f"phase 14 mt_closest brute force on {o.shape[0]} rays x {verts.shape[0]} triangles, "
            f"equal to the torch brute force on {DRAGON_BRUTE_RAYS} of them bit for bit" + timed)
        return tk, ik

    for k, (qo, qd, qt), (so, sd, st) in bounces(dscene, fcfg, o_all[w], d_all[w], raw_all[w],
                                                 (0, LATER_BOUNCE), DRAGON_PARITY_RAYS):
        refs, raws = closest_refs(dkd, dverts, ddepth, qo, qd, qt, dplains, DRAGON_PARITY_RAYS, mt_brute)
        pr = per_ray(dkd, qo, qd, qt, ddepth, False)
        dpar["packet_traverse_per_ray"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "packet_traverse_per_ray", pr, refs, dverts, qo, qd, qt)
        fpr = forest.forest_traverse_per_ray(dkd, qo, qd, qt, ddepth, False)
        refs["per_ray"] = (*pr[:2], pr[2] & (pr[0] < qt), qo.shape[0])
        dpar["forest_walk_per_ray"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "forest_walk_per_ray", fpr, refs, dverts, qo, qd, qt)
        pk = packet_walk(dkd, qo, qd, qt, ddepth, False)
        for kname, out, others in (("packet_traverse", pk, dict(raws, per_ray=pr)),
                                   ("forest_walk", forest.forest_traverse(dkd, qo, qd, qt, ddepth, False),
                                    dict(raws, per_ray=pr, forest_per_ray=fpr, packet_traverse=pk))):
            dpar[kname][f"closest_b{k}"] = check_warp(f"bounce {k}, dragon", kname, dkd, out, others, qo, qd)
            dpar[kname][f"closest_b{k}"].update(check_closest(
                f"bounce {k}", kname, out, {"brute": refs["brute"]}, dverts, qo, qd, qt))
        del raws, fpr
        dpar["block_loop"][f"closest_b{k}"] = check_closest(
            f"bounce {k}", "binned walk", binned.binned_traverse(dkd, qo, qd, qt, ddepth, False), refs,
            dverts, qo, qd, qt)
        # brute force on the shadow rays of the first DRAGON_BRUTE_RAYS points, per light
        L = dscene.lights.position.shape[0]
        sub = torch.cat([torch.arange(li * DRAGON_PARITY_RAYS, li * DRAGON_PARITY_RAYS + DRAGON_BRUTE_RAYS,
                                      device=dev) for li in range(L)])
        outs = {"packet_traverse_per_ray": per_ray(dkd, so, sd, st, ddepth, True),
                "packet_traverse": packet_walk(dkd, so, sd, st, ddepth, True),
                "forest_walk_per_ray": forest.forest_traverse_per_ray(dkd, so, sd, st, ddepth, True),
                "forest_walk": forest.forest_traverse(dkd, so, sd, st, ddepth, True),
                "block_loop": binned.binned_traverse(dkd, so, sd, st, ddepth, True)}
        aplain = {name: walk(dkd, so, sd, st, ddepth, True) for name, walk in dplains.items()}
        arefs = {name: (*out[1:], so.shape[0]) for name, out in aplain.items()}
        for kname in ("packet_traverse_per_ray", "packet_traverse"):
            dpar[kname][f"any_b{k}"] = check_any(f"bounce {k}", kname, outs[kname], arefs, dverts, so, sd, st)
        arefs["per_ray"] = (*outs["packet_traverse_per_ray"][1:], so.shape[0])
        for kname in ("forest_walk_per_ray", "forest_walk"):
            dpar[kname][f"any_b{k}"] = check_any(f"bounce {k}", kname, outs[kname], arefs, dverts, so, sd, st)
        dpar["block_loop"][f"any_b{k}"] = check_any(f"bounce {k}", "binned walk", outs["block_loop"], arefs,
                                                    dverts, so, sd, st)
        check_any_t_prim(f"bounce {k}, dragon", outs["block_loop"], aplain)
        del aplain
        so, sd, st = so[sub], sd[sub], st[sub]
        brefs = {"brute": (None, brute_any(dverts, so, sd, st), so.shape[0])}
        for kname, out in outs.items():
            dpar[kname][f"any_b{k}"].update(check_any(
                f"bounce {k}, {DRAGON_BRUTE_RAYS} points per light", kname, [x[sub] for x in out], brefs,
                dverts, so, sd, st))

    check(bool(dragon_brute), "phase 14 did not time the dragon brute force")
    brute_entries["mt_closest"]["dragon"] = dragon_brute

    # ---- 15. flagship kernel times and bounds ----
    tstart = wstart // dtile * dtile
    tile_rays = [x[tstart:tstart + dtile] for x in (o_all, d_all, raw_all)]
    td = next(bounces(dscene, fcfg, *tile_rays, (0,), dtile))
    del o_all, d_all, raw_all
    dinputs = {"closest": td[1], "any_hit": td[2]}
    T, cap = dkd.tre_tbl.shape[:2]
    dkernels = []
    for name, nodes_bytes, counts_of in (
            ("packet_traverse", dM * 20, flag_counts),
            ("forest_walk", dkd.top_tbl.shape[0] * 16 + T * cap * 24, forest_counts)):
        for mode in ("closest", "any_hit"):
            par = dpar[name]
            key = "closest" if mode == "closest" else "any"
            extra = dict(scene="dragon", parity={"bounce0": par[f"{key}_b0"],
                                                 f"bounce{LATER_BOUNCE}": par[f"{key}_b{LATER_BOUNCE}"]})
            entry = kernel_entry(name, mode, dkd, dinputs[mode], ddepth, counts_of[mode],
                                 plain_err(par, mode, dplains), nodes_bytes, extra)
            if name == "packet_traverse":
                entry["name"] = f"packet_traverse[{mode},dragon]"
            else:
                entry["frame_s"], entry["frame_sorts"] = forest_s, forest_sorts
            dkernels.append(entry)
    attach_bounces(dkernels, per_bounce("dragon", dscene, fcfg, *tile_rays, "forest_walk"), "forest_walk")
    kernels += dkernels
    del tile_rays
    for mode in ("closest", "any_hit"):  # the whole binned walk of the tile
        key = "closest" if mode == "closest" else "any"
        tw = tile_walks("dragon", dkd, dinputs[mode], ddepth, mode == "any_hit")
        _, launched = binned_walk(dkd, dinputs[mode], ddepth, mode == "any_hit")
        par = dpar["block_loop"]
        extra = dict(scene="dragon", frame_s=dbin_s, frame_sorts=binned_sorts and binned_sorts["dragon"])
        kernels.append(block_loop_entry(",dragon", mode, dkd, launched, tw, dbin_counts["block_loop"][mode], dict(
            extra, parity={"bounce0": par[f"{key}_b0"], f"bounce{LATER_BOUNCE}": par[f"{key}_b{LATER_BOUNCE}"]})))
        del launched
        kernels.append(descend_entry(",dragon", mode, dkd, dinputs[mode], ddepth,
                                     dbin_counts["binned_descend"][mode], extra))
    log("phase 15 flagship kernel times")

    # ---- 16. where one flagship frame's device time goes ----
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = wall_s(torch, lambda: render_image(dscene, fcfg, device=dev))[0] * 1e3
    launches_per_frame = sum(packet.launches.values())
    dev_ms = device_ms(torch, prof)
    busy = sum(dev_ms.values())
    if busy > 0:
        ours = sum(v for k, v in dev_ms.items() if "PacketNodes" in k)  # kd_warp.cuh warp_walk_kernel<PacketNodes>
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({"profile": {
            "frame": "dragon flagship, auto", "frame_wall_ms": prof_wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / prof_wall_ms),
            "traversal_kernel_ms": ours, "traversal_share_of_busy": ours / busy,
            "traversal_launches": launches_per_frame, "traversal_launches_by_mode": dict(packet.launches),
            "traversal_mean_launch_ms": ours / max(launches_per_frame, 1),
            "top": [{"name": k[:90], "ms": v} for k, v in top]}}), flush=True)
    else:
        print(json.dumps({"profile": "not measured: the profiler recorded no device time"}), flush=True)
    log("phase 16 profile")

    # ---- 17-19. the gradient path ----
    grads = grad_phases(torch, dev, dscene, fcfg, flag_s, reset_counts, read_counts)
    grad_verts = grads.pop("vertex_grads")
    print(json.dumps({"grad": grads}), flush=True)
    gf = grads["grad_frame"]
    for e in kernels:  # each kernel's launches on the gradient path, forward / backward
        if e["name"] in ("packet_traverse[closest,dragon]", "packet_traverse[any_hit,dragon]"):
            mode = e["name"].split("[")[1].split(",")[0]
            e["grad_frame_launches"] = {"forward": gf["launches_forward"]["packet_traverse"][mode], "backward": 0}
        elif e["name"].split("[")[0] in grads["brute_vs_kd"]:
            e["grad_launches"] = {"forward": grads["brute_vs_kd"][e["name"].split("[")[0]]["launches_forward"],
                                  "backward": 0, "frame": "teapot 64x32, 3 bounces"}

    # ---- 20-23. the CLI, the tiled job, bounce_skip, reversed shadow rays ----
    torch.cuda.empty_cache()  # the CLI's process shares the card
    import numpy as np

    from dod_raytracer_tpu_torch import SceneBuilder
    from dod_raytracer_tpu_torch.checkpoint import TiledRenderJob
    from dod_raytracer_tpu_torch.io import read_png
    from dod_raytracer_tpu_torch.mesh import load_mesh_asset
    from dod_raytracer_tpu_torch.shading import reversed_rays

    teapot_u8, flag_u8 = quantize_u8(teapot_ref), quantize_u8(flag_ref)

    def u8_share(a, b) -> float:
        """Fraction of u8 channels of two quantized frames that differ by more than 1."""
        return float((np.abs(a.astype(int) - b.astype(int)) > 1).mean())

    def pixel_share(a, b) -> float:
        """tests/test_render_golden.py:212-215: the share of pixels whose
        largest channel differs by more than 1e-3."""
        return float(((a - b).abs().amax(dim=-1) > 1e-3).float().mean())

    new_paths = {}  # the packet walk's launches on this slice's paths

    # ---- 20. the CLI on the card, in a subprocess ----
    t20 = time.perf_counter()

    def run_cli(label, args, tmp):
        """``python -m dod_raytracer_tpu_torch.cli`` with ``args`` in a
        subprocess -> (the seconds it printed, its wall seconds, the scene
        build seconds it printed); its kd tree must come from the native
        builder."""
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "dod_raytracer_tpu_torch.cli", *args], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        check(out.returncode == 0, f"{label}: the CLI exited {out.returncode}: {out.stderr[-3000:]}")
        m = re.search(r"rendered (\d+)x(\d+) in ([0-9.]+)s \(([0-9.]+) Mprimary-rays/s\) -> ", out.stdout)
        check(m is not None, f"{label}: no 'rendered' line in {out.stdout[-2000:]!r}")
        b = re.search(r"built the scene in ([0-9.]+)s \(kd builder: (\w+)\)", out.stdout)
        check(b is not None and b.group(2) == "native", f"{label}: the kd tree was not built natively: {out.stdout!r}")
        return float(m.group(3)), wall, float(b.group(1))

    cli = {}
    with tempfile.TemporaryDirectory() as tmp:
        png, trace_dir = os.path.join(tmp, "cli.png"), os.path.join(tmp, "trace")
        sec, wall, build = run_cli("CLI teapot", ["--config", os.path.join(ROOT, "config.ini"), "--seed", "0",
                                                  "--output", png], tmp)
        got = read_png(png)
        check(got.shape == teapot_u8.shape, f"CLI teapot PNG shape {got.shape}")
        off = u8_share(got, teapot_u8)
        check(off < U8_TOLERANCE, f"CLI teapot frame: {off:.4%} of u8 channels off by > 1 from phase 4's frame")
        # --profile on a smaller frame of the same scene: the profiler's cost per op and a 1080p
        # trace of about 1 GB would take most of this phase
        prof_sec, prof_wall, _ = run_cli("CLI teapot, --profile", [
            "--config", os.path.join(ROOT, "config.ini"), "--seed", "0", "--width", str(CLI_PROFILE_SIZE[0]),
            "--height", str(CLI_PROFILE_SIZE[1]), "--output", os.path.join(tmp, "cli_profiled.png"),
            "--profile", trace_dir], tmp)
        trace = os.path.join(trace_dir, "trace.json")
        check(os.path.exists(trace), "CLI teapot: --profile wrote no trace.json")
        named = {n: False for n in ("scene_build", "render", "png_write")}
        kernels_named = {}
        with open(trace) as f:  # read in pieces that end at a line end: the trace is large
            rest = ""
            for piece in iter(lambda: f.read(1 << 26), ""):
                text, _, rest = (rest + piece).rpartition("\n")
                named.update({n: True for n in named if f'"{n}"' in text})
                for name in re.findall(r'"name":\s*"([^"]*PacketNodes[^"]*)"', text):
                    kernels_named[name[:100]] = kernels_named.get(name[:100], 0) + 1
        check(all(named.values()) and kernels_named, f"CLI trace: phases {named}, packet kernels {kernels_named}")
        cli["teapot"] = dict(seconds=sec, wall_s=wall, build_s=build, u8_off=off,
                             config="config.ini (MaxPrims=8, leaf_chunk_lanes=8, ray_tile=32768)",
                             profiled=dict(size=list(CLI_PROFILE_SIZE), seconds=prof_sec, wall_s=prof_wall,
                                           trace_bytes=os.path.getsize(trace), phases_named=named,
                                           packet_kernels_in_trace=kernels_named))
        new_paths["cli_teapot_trace"] = kernels_named
        ini = os.path.join(tmp, "dragon.ini")
        with open(ini, "w") as f:
            f.write("Width: 1920\nHeight: 1080\nMaxPrims: 192\nleaf_chunk_lanes: 48\nray_tile: 0\n")
        png = os.path.join(tmp, "dragon.png")
        sec, wall, build = run_cli("CLI dragon", ["--config", ini, "--mesh", "dragon", "--seed", "0", "--output", png],
                                   tmp)
        got = read_png(png)
        off = u8_share(got, flag_u8)
        check(off < U8_TOLERANCE, f"CLI dragon frame: {off:.4%} of u8 channels off by > 1 from phase 11's frame")
        cli["dragon"] = dict(seconds=sec, wall_s=wall, build_s=build, u8_off=off, bit_equal=bool((got == flag_u8).all()))
        # the dragon as a user gets it with config.ini alone: MaxPrims=8, leaf_chunk_lanes=8
        png = os.path.join(tmp, "dragon_ini.png")
        sec, wall, build = run_cli("CLI dragon, config.ini", ["--config", os.path.join(ROOT, "config.ini"), "--mesh",
                                                              "dragon", "--seed", "0", "--output", png], tmp)
        got = read_png(png)
        off = u8_share(got, flag_u8)
        check(off < U8_TOLERANCE, f"CLI dragon frame (config.ini): {off:.4%} of u8 channels off by > 1 from phase 11's")
        cli["dragon_config_ini"] = dict(seconds=sec, wall_s=wall, build_s=build, u8_off=off,
                                        numpy_build_s_earlier=NUMPY_DRAGON_INI_BUILD_S)
    cli["phase_s"] = time.perf_counter() - t20
    print(json.dumps({"cli": cli}), flush=True)
    log(f"phase 20 CLI in a subprocess on {card}: teapot (config.ini) rendered in "
        f"{cli['teapot']['seconds']:.3f} s ({cli['teapot']['wall_s']:.1f} s wall), {cli['teapot']['u8_off']:.4%} "
        f"of u8 channels off by > 1 from phase 4's frame; at {CLI_PROFILE_SIZE[0]}x{CLI_PROFILE_SIZE[1]} with "
        f"--profile {prof_sec:.3f} s ({prof_wall:.1f} s wall), trace names {named} and packet kernels "
        f"{json.dumps(kernels_named)}; dragon rendered in {cli['dragon']['seconds']:.3f} s "
        f"({cli['dragon']['wall_s']:.1f} s wall), {cli['dragon']['u8_off']:.4%} off from phase 11's frame; "
        f"the dragon with config.ini alone (MaxPrims=8) rendered in {cli['dragon_config_ini']['seconds']:.3f} s, "
        f"{cli['dragon_config_ini']['u8_off']:.4%} off; scenes built by the native kd builder in "
        f"{cli['teapot']['build_s']:.3f} s (teapot), {cli['dragon']['build_s']:.3f} s (dragon, MaxPrims=192), "
        f"{cli['dragon_config_ini']['build_s']:.3f} s (dragon, MaxPrims=8; the numpy build took "
        f"{NUMPY_DRAGON_INI_BUILD_S} s on this machine's host in an earlier run, scripts/torch_build_time.py)")

    # ---- 20b. the inverse-rendering example ----
    spec = importlib.util.spec_from_file_location("inverse_rendering_torch",
                                                  os.path.join(ROOT, "examples", "inverse_rendering_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(text):
        ex_s, rc = wall_s(torch, lambda: example.main(["--outdir", tmp]))
        pngs = sorted(os.listdir(tmp))
    text = text.getvalue()
    print(text, end="", flush=True)
    m = re.search(r"loss ([0-9.e+-]+) -> ([0-9.e+-]+) over (\d+) steps", text)
    a = re.search(r"max albedo error ([0-9.]+), light-intensity error ([0-9.]+)", text)
    check(rc == 0 and m is not None and a is not None, f"inverse-rendering example: exit {rc}, output {text[-2000:]!r}")
    check(float(m.group(2)) < float(m.group(1)), f"inverse-rendering example: the loss did not fall: {m.group(0)}")
    check(pngs == ["initial.png", "recovered.png", "target.png"], f"inverse-rendering example wrote {pngs}")
    example_out = dict(seconds=ex_s, steps=int(m.group(3)), loss_first=float(m.group(1)), loss_last=float(m.group(2)),
                       albedo_err=float(a.group(1)), intensity_err=float(a.group(2)))
    print(json.dumps({"inverse_rendering_example": example_out}), flush=True)
    log(f"phase 20b examples/inverse_rendering_torch.py on {card} (96x64, 3 bounces, no kd tree, "
        f"{example_out['steps']} Adam steps): {ex_s:.3f} s, loss {m.group(1)} -> {m.group(2)}, max albedo error "
        f"{a.group(1)}, light-intensity error {a.group(2)}")

    # ---- 21. the resumable tiled render ----
    t21 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        first = TiledRenderJob(work, fcfg, tile=262144, owner=0, num_owners=2, device=dev)
        check(first.num_tiles == 8, f"tiled job: {first.num_tiles} tiles")
        s_first, res = wall_s(torch, lambda: first.run(dscene))
        check(res is None and first.done_tiles() == [0, 2, 4, 6],
              f"tiled job, owner 0 of 2: returned {type(res)}, tiles {first.done_tiles()}")
        resume = TiledRenderJob(work, fcfg, tile=262144, device=dev)
        reset_counts()
        s_resume, tiled = wall_s(torch, lambda: resume.run(dscene))
        counts = read_counts()
    check(tiled is not None and tiled.shape == (fcfg.Height, fcfg.Width, 3), "tiled job: no full frame on resume")
    want = {"closest": 4 * fcfg.recursion_depth, "any_hit": 4 * fcfg.recursion_depth}
    others = [k for k, modes in counts.items() if k != "packet_traverse" and any(modes.values())]
    check(counts["packet_traverse"] == want and not others,
          f"tiled resume launches {counts}, want packet {want} and nothing else")
    tiled_off = u8_share(quantize_u8(torch.from_numpy(tiled)), flag_u8)
    check(tiled_off < U8_TOLERANCE, f"tiled frame: {tiled_off:.4%} of u8 channels off by > 1 from phase 11's")
    tiles = dict(first_s=s_first, resume_s=s_resume, write_s=first.write_seconds + resume.write_seconds,
                 launches_resume=counts["packet_traverse"], u8_off=tiled_off, tile=262144, tiles=8,
                 phase_s=time.perf_counter() - t21)
    new_paths["tiled_resume"] = counts["packet_traverse"]
    print(json.dumps({"tiled_job": tiles}), flush=True)
    log(f"phase 21 tiled job on the flagship scene on {card}: owner 0 of 2 rendered tiles 0, 2, 4, 6 in "
        f"{s_first:.3f} s; the resume rendered 4 tiles in {s_resume:.3f} s, launches {counts['packet_traverse']}; "
        f".npy writes {tiles['write_s']:.3f} s in all; the frame {tiled_off:.4%} off phase 11's")
    del tiled

    # ---- 22. bounce_skip ----
    t22 = time.perf_counter()
    ocfg = Config(Width=1920, Height=1080, ray_tile=0)  # tests/test_render_golden.py:82-101, at 1080p
    ob = SceneBuilder()
    ob.add_mesh(*load_mesh_asset("teapot"))
    ob.add_sphere((2.5, 0.0, 1.0), 0.8, (0.9, 0.3, 0.2))
    ob.add_light((0.0, 3.0, -3.0), 3.0)
    oscene = ob.build(ocfg, device=dev)
    skip = {}
    for on in (False, True):
        c = dataclasses.replace(ocfg, bounce_skip=on)
        wall_s(torch, lambda: render_image(oscene, c, device=dev))
        sec, im, cnt = frame(oscene, c, f"open scene, bounce_skip={on}", "packet_traverse")
        skip[on] = dict(seconds=sec, launches=cnt, img=im)
    check(torch.equal(skip[True]["img"], skip[False]["img"]), "open scene: bounce_skip changed the frame")
    check(sum(skip[True]["launches"].values()) < sum(skip[False]["launches"].values()),
          f"open scene: bounce_skip launched no fewer walks: {skip[True]['launches']} vs {skip[False]['launches']}")
    open_turns = sort_samples(oscene, ocfg, KNOB_REPS, "bounce_skip")
    o_s, d_s, raw_s, _, s_tile = frame_rays(ocfg, dev)
    skipped = []
    with torch.no_grad():
        for s0 in range(0, o_s.shape[0], s_tile):
            reset_counts()
            render_rays(oscene, o_s[s0:s0 + s_tile], d_s[s0:s0 + s_tile], raw_s[s0:s0 + s_tile],
                        dataclasses.replace(ocfg, bounce_skip=True))
            skipped.append(ocfg.recursion_depth - packet.launches["closest"])
    reset_counts()
    box_cfg = dataclasses.replace(cfg, bounce_skip=True)
    box_s, box_img, box_counts = frame(scene, box_cfg, "teapot frame, bounce_skip", "packet_traverse")
    check(torch.equal(box_img, teapot_ref), "teapot frame: bounce_skip changed phase 4's frame")
    box_turns = sort_samples(scene, cfg, KNOB_REPS, "bounce_skip")
    bskip = dict(open_scene={("on" if on else "off"): {k: v for k, v in r.items() if k != "img"}
                             for on, r in skip.items()},
                 open_turns=open_turns, open_bounces_skipped_per_tile=skipped, open_tile=s_tile, open_mean=float(skip[True]["img"].mean()),
                 teapot_seconds=box_s, teapot_launches=box_counts, teapot_phase4_seconds=frame_s,
                 teapot_turns=box_turns, phase_s=time.perf_counter() - t22)
    new_paths["bounce_skip"] = {"open_scene_on": skip[True]["launches"], "open_scene_off": skip[False]["launches"],
                                "teapot_on": box_counts}
    print(json.dumps({"bounce_skip": bskip}), flush=True)
    log(f"phase 22 bounce_skip on {card}: open scene 1920x1080 off {skip[False]['seconds']:.3f} s "
        f"{skip[False]['launches']}, on {skip[True]['seconds']:.3f} s {skip[True]['launches']}, bit-equal; in turns "
        f"{json.dumps(open_turns)}; "
        f"bounces skipped per tile {skipped}; phase 4's frame with it {box_s:.3f} s (phase 4: {frame_s:.3f} s), "
        f"bit-equal, launches {box_counts}; seconds with it on and off, in turns: {json.dumps(box_turns)}")
    del skip, oscene, box_img

    # ---- 23. reversed shadow rays ----
    t23 = time.perf_counter()
    o_all, d_all, raw_all, _, _ = frame_rays(fcfg, dev)
    tile_rays = [x[tstart:tstart + dtile] for x in (o_all, d_all, raw_all)]
    del o_all, d_all, raw_all
    L = dscene.lights.position.shape[0]
    rev = {}
    for k, _, (so, sd, st) in bounces(dscene, fcfg, *tile_rays, (0, LATER_BOUNCE), dtile):
        ro, rd = (x.contiguous() for x in reversed_rays(dscene, sd))  # st: the window, family-blocked pairs killed
        out = packet_walk(dkd, ro, rd, st, ddepth, True)
        sel = torch.cat([torch.arange(li * dtile, li * dtile + SHADOW_POINTS, device=dev) for li in range(L)])
        sub = torch.cat([torch.arange(li * dtile, li * dtile + DRAGON_BRUTE_RAYS, device=dev) for li in range(L)])
        po, pd, pt = ro[sel], rd[sel], st[sel]
        plain = traverse_plain(dkd, po, pd, pt, ddepth, True)
        par = check_any(f"reversed, bounce {k}", "packet_traverse", [x[sel] for x in out],
                        {"plain": (*plain[1:], po.shape[0])}, dverts, po, pd, pt)
        par.update(check_any(f"reversed, bounce {k}, {DRAGON_BRUTE_RAYS} points per light", "packet_traverse",
                             [x[sub] for x in out],
                             {"brute": (None, brute_any(dverts, ro[sub], rd[sub], st[sub]), sub.numel())},
                             dverts, ro[sub], rd[sub], st[sub]))
        fwd_out = packet_walk(dkd, so, sd, st, ddepth, True)
        ms = time_turns(torch, {"reversed": lambda: packet_walk(dkd, ro, rd, st, ddepth, True),
                                "forward": lambda: packet_walk(dkd, so, sd, st, ddepth, True)}, TIMING_REPS)
        rb = work_bound(per_ray, dkd, (ro, rd, st), ddepth, True, dM * 20)
        fb = work_bound(per_ray, dkd, (so, sd, st), ddepth, True, dM * 20)
        rev[f"bounce{k}"] = dict(rays=ro.shape[0], live_rays=int((st >= 0).sum()), occluded=int(out[2].sum()),
                                 occluded_forward=int(fwd_out[2].sum()),
                                 bits_differ_from_forward=int((out[2] != fwd_out[2]).sum()),
                                 reversed_ms=ms["reversed"], forward_ms=ms["forward"],
                                 reversed_bound=rb, forward_bound=fb, parity=par,
                                 reversed_warp_stats=packet_stats(dkd, (ro, rd, st), ddepth, True),
                                 forward_warp_stats=packet_stats(dkd, (so, sd, st), ddepth, True))
        log(f"phase 23 reversed shadow rays, bounce {k}, {ro.shape[0]} rays of the flagship tile at {tstart} on "
            f"{card}: in turns reversed {ms['reversed']:.3f} ms/launch (bound {rb['bound_ms']:.4f} ms, "
            f"{rb['bound_by']}), forward {ms['forward']:.3f} ms (bound {fb['bound_ms']:.4f} ms, {fb['bound_by']}); "
            f"any-hit bits equal to the plain walk's on {po.shape[0]} rays; occluded {int(out[2].sum())} reversed, "
            f"{int(fwd_out[2].sum())} forward")
        del ro, rd, out, fwd_out, plain, po, pd, pt
    del tile_rays
    rframes = {}
    for label, sc, base, ref in (("teapot", scene, cfg, teapot_ref), ("dragon", dscene, fcfg, flag_ref)):
        rc = dataclasses.replace(base, shadow_reverse=True)
        wall_s(torch, lambda: render_image(sc, rc, device=dev))
        sec, im, cnt = frame(sc, rc, f"{label} frame, shadow_reverse", "packet_traverse")
        px, u8 = pixel_share(im, ref), u8_off(quantize_u8, im, ref)
        check(px < 0.02 and u8 < U8_TOLERANCE,
              f"{label} shadow_reverse frame: {px:.4%} of pixels off by > 1e-3, {u8:.4%} of u8 channels by > 1")
        rframes[label] = dict(seconds=sec, forward_seconds=frame_s if label == "teapot" else flag_s,
                              launches=cnt, pixels_off=px, u8_off=u8, sort_shadow=_sort_shadow(sc, rc),
                              turns=sort_samples(sc, base, KNOB_REPS, "shadow_reverse"))
        del im
    rev["frames"] = rframes
    rev["phase_s"] = time.perf_counter() - t23
    new_paths["shadow_reverse_frames"] = {k: v["launches"] for k, v in rframes.items()}
    print(json.dumps({"shadow_reverse": rev}), flush=True)
    log(f"phase 23 shadow_reverse frames on {card}: " + "; ".join(
        f"{k} {v['seconds']:.3f} s (forward {v['forward_seconds']:.3f} s, sort_shadow={v['sort_shadow']}), "
        f"{v['pixels_off']:.4%} of pixels off by > 1e-3, {v['u8_off']:.4%} of u8 channels by > 1, launches "
        f"{v['launches']}; seconds reversed (on) and forward (off), in turns: {json.dumps(v['turns'])}"
        for k, v in rframes.items()))
    for e in kernels:  # the packet walk's entries gain this slice's paths
        if e["name"] == "packet_traverse[any_hit,dragon]":
            e["reversed_shadow"] = {b: {key: rev[b][key] for key in ("rays", "live_rays", "reversed_ms", "forward_ms")}
                                    | {"bound_ms": rev[b]["reversed_bound"]["bound_ms"],
                                       "bound_by": rev[b]["reversed_bound"]["bound_by"],
                                       "forward_bound_ms": rev[b]["forward_bound"]["bound_ms"]}
                                    for b in ("bounce0", f"bounce{LATER_BOUNCE}")}
            e["reversed_shadow"]["launches_per_frame"] = rframes["dragon"]["launches"]["any_hit"]
        if e["name"].startswith("packet_traverse[") and e["name"].endswith(",dragon]"):
            e["new_paths"] = new_paths

    # ---- 24-26. distribution: the dp render, the leaf-sharded render, the train steps ----
    from dod_raytracer_tpu_torch.parallel import leaf_shard, multihost, sharding

    torch.cuda.empty_cache()  # the ranks' processes share the card
    t24 = time.perf_counter()
    dist_out = {"card": card, "note": "ranks share one card: their times do not measure scaling"}

    def held(label, ranks):
        """Each rank's frame against phase 11's (shape, u8 rule) -> the
        ranks' numbers without their frames and gradients."""
        out = []
        for r in ranks:
            off = u8_share(r.pop("u8"), flag_u8)
            check(r["shape"] == [fcfg.Height, fcfg.Width, 3] and off < U8_TOLERANCE,
                  f"{label} rank {r['rank']}: {off:.4%} of u8 channels off by > 1 from phase 11's frame")
            r["u8_off"] = off
            out.append(r)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as rdzv:
        # ---- 24. dp render: an NCCL world of one rank a card, then gloo ranks sharing the card ----
        ncards = torch.cuda.device_count()
        if ncards == 1:  # the world of one rank is this process
            backend = multihost.initialize(device="cuda", timeout_s=DIST_TIMEOUT_S)
            try:
                mesh = sharding.make_mesh()
                setup_s, rscene = wall_s(torch, lambda: sharding.replicate_scene(dscene, mesh))
                nccl = [dict(rank=0, backend=backend, device=str(mesh.device), setup_s=setup_s,
                             **timed_frame(torch, lambda: sharding.render_image_sharded(rscene, fcfg, mesh),
                                           quantize_u8))]
                del rscene
            finally:
                torch.distributed.destroy_process_group()
        else:
            nccl = multihost.spawn(ncards, dp_rank, f"file://{rdzv}/nccl", False, timeout_s=DIST_TIMEOUT_S)
        gloo = multihost.spawn(DP_WORLD, dp_rank, f"file://{rdzv}/dp", True, timeout_s=DIST_TIMEOUT_S)
        check(all(r["backend"] == "nccl" for r in nccl) and all(r["backend"] == "gloo" for r in gloo),
              f"backends: {[r['backend'] for r in nccl]}, {[r['backend'] for r in gloo]}")
        dist_out["dp_nccl"], dist_out["dp_gloo"] = held("dp NCCL frame", nccl), held("dp gloo frame", gloo)
        dp_steps = [r.pop("step") for r in gloo]
        dist_out["phase24_s"] = time.perf_counter() - t24
        log(f"phase 24 dp render of the flagship frame on {card}: NCCL, world {ncards}: "
            + "; ".join(f"rank {r['rank']} {r['seconds']:.3f} s, launches {r['launches']}, {r['u8_off']:.4%} u8 off"
                        for r in dist_out["dp_nccl"])
            + f" | gloo, world {DP_WORLD} on the one card: "
            + "; ".join(f"rank {r['rank']} {r['seconds']:.3f} s (scene built and broadcast {r['setup_s']:.2f} s), "
                        f"launches {r['launches']}, {r['u8_off']:.4%} u8 off" for r in dist_out["dp_gloo"])
            + f" (phase 11's frame {flag_s:.3f} s)")

        # ---- 25. leaf-sharded render: (dp, mp) gloo worlds sharing the card ----
        t25 = time.perf_counter()
        leaf = {}
        for shape in LEAF_SHAPES:
            leaf[shape] = multihost.spawn(shape[0] * shape[1], leaf_rank, f"file://{rdzv}/leaf{shape[0]}x{shape[1]}",
                                          shape, shape == (1, 2), timeout_s=DIST_TIMEOUT_S)
    for shape, ranks in leaf.items():
        for r in ranks:
            check(r["shard"]["sort_bounces"] and r["shard"]["sort_shadow"],
                  f"leaf {shape} rank {r['rank']}: the default sorts are off: {r['shard']}")
        dist_out[f"leaf_{shape[0]}x{shape[1]}"] = held(f"leaf-sharded {shape} frame", ranks)
    step_2d = [r.pop("step_2d") for r in leaf[(1, 2)]]

    # the packet walk on one shard's tree against its plain walk: phase 14's window at bounce 0 and
    # LATER_BOUNCE, its closest-hit queries and its first SHADOW_POINTS points' shadow rays
    soup = [x.cpu().numpy() for x in (dscene.triangles.verts, dscene.triangles.normals, dscene.triangles.mesh_id)]
    _, skd, _ = leaf_shard.build_leaf_sharded_triangles(*soup, fcfg, 2, 0, device=dev)
    sdepth = _stack_depth(skd, fcfg)
    o_all, d_all, raw_all, _, _ = frame_rays(fcfg, dev)
    window = [x[wstart:wstart + DRAGON_PARITY_RAYS] for x in (o_all, d_all, raw_all)]
    del o_all, d_all, raw_all
    shard_parity = {"nodes": skd.node_flag.shape[0], "blocks": skd.block_g.shape[0]}
    for k, closest_q, shadow_q in bounces(dscene, fcfg, *window, (0, LATER_BOUNCE), SHADOW_POINTS):
        for mode, (qo, qd, qt) in (("closest", closest_q), ("any_hit", shadow_q)):
            any_hit = mode == "any_hit"
            out = packet_walk(skd, qo, qd, qt, sdepth, any_hit)
            res = packet.parity(skd, out, traverse_plain(skd, qo, qd, qt, sdepth, any_hit), qo, qd, any_hit)
            check(packet.parity_holds(res), f"packet walk on shard 0's tree, bounce {k} {mode}: {res}")
            shard_parity[f"bounce{k}_{mode}"] = dict(res, hits=int(out[2].sum()))
    dist_out["shard_parity"] = shard_parity
    dist_out["phase25_s"] = time.perf_counter() - t25
    for shape in LEAF_SHAPES:
        log(f"phase 25 leaf-sharded flagship frame, (dp, mp) = {shape}, gloo on {card}: " + "; ".join(
            f"rank {r['rank']} {r['coords']} {r['seconds']:.3f} s (shard of {r['shard']['triangles']} triangles, "
            f"{r['shard']['nodes']} nodes, {r['shard']['blocks']} blocks; built {r['setup_s']:.2f} s), "
            f"launches {r['launches']}, {r['u8_off']:.4%} u8 off; with the combine counted "
            f"{r['comm']['frame_seconds']:.3f} s, {r['comm']['calls']} collectives, {r['comm']['bytes'] / 1e6:.1f} MB, "
            f"{r['comm']['seconds']:.3f} s in them" for r in dist_out[f"leaf_{shape[0]}x{shape[1]}"]))
    log(f"phase 25 packet walk on shard 0 of 2 ({shard_parity['nodes']} nodes, {shard_parity['blocks']} blocks) "
        f"vs its plain walk, the packet rule: {json.dumps(shard_parity)}")

    # ---- 26. the train steps: the 1D dp step (phase 24's world), the 2D step (phase 25's (1, 2) world) ----
    n_px = fcfg.Width * fcfg.Height
    dp_loss = float(torch.mean((flag_ref - DP_TARGET) ** 2))
    for r, st in zip(dist_out["dp_gloo"], dp_steps):
        check(math.isclose(st["losses"][0], dp_loss, rel_tol=1e-5),
              f"1D step rank {r['rank']}: loss {st['losses'][0]} vs the single-process {dp_loss}")
    loss_2d = grads["grad_frame"]["loss"] / (3 * n_px)  # phase 17's sum of squares, as a mean
    for r, st in zip(dist_out["leaf_1x2"], step_2d):
        check(math.isclose(st["loss"], loss_2d, rel_tol=1e-5),
              f"2D step rank {r['rank']}: loss {st['loss']} vs the single-process {loss_2d}")
    by_mp = {r["coords"]["mp"]: st.pop("grad") for r, st in zip(dist_out["leaf_1x2"], step_2d)}
    morton = np.concatenate([by_mp[i] for i in range(2)])[:dscene.n_triangles]
    g_2d = np.empty_like(morton)
    g_2d[leaf_shard._morton_order(soup[0])] = morton
    g_2d = torch.from_numpy(g_2d).to(dev) * (3 * n_px)  # the gradient of phase 17's sum of squares
    rule = grad_close(grad_verts, g_2d, rtol=1e-3, atol=1e-6 * float(grad_verts.abs().max()))
    check(rule["rel_l1"] < CARD_CPU_L1 and rule["share_off"] <= CARD_CPU_SHARE,
          f"2D step vertex grads vs phase 17's: {rule}")
    dist_out["step_1d"] = dict(world=DP_WORLD, params=DP_PARAMS, single_loss=dp_loss, ranks=dp_steps)
    dist_out["step_2d"] = dict(shape=[1, 2], single_loss=loss_2d, vs_phase17=rule, ranks=step_2d)
    dist_out["phase_s"] = time.perf_counter() - t24
    del g_2d, morton, by_mp, grad_verts
    print(json.dumps({"distributed": dist_out}), flush=True)
    log(f"phase 26 train steps on {card}: 1D dp step (world {DP_WORLD}, {DP_PARAMS}, remat_bounces) losses "
        + "; ".join(f"rank {r['rank']} {st['losses']} in {st['seconds']} s" for r, st in zip(dist_out['dp_gloo'], dp_steps))
        + f" (single-process {dp_loss:.9e}); 2D step (1, 2) on the dragon's vertices: "
        + "; ".join(f"rank {r['rank']} loss {st['loss']:.9e}, gradient {st['grad_seconds']:.3f} s (launches "
                    f"{st['launches']}), a step {st['step_seconds']:.3f} s"
                    for r, st in zip(dist_out["leaf_1x2"], step_2d))
        + f" (single-process {loss_2d:.9e}); its vertex grads vs phase 17's {json.dumps(rule)}")
    sharded = {"dp_nccl": dist_out["dp_nccl"], "dp_gloo": dist_out["dp_gloo"],
               "leaf_1x2": dist_out["leaf_1x2"], "leaf_2x2": dist_out["leaf_2x2"]}
    for e in kernels:  # the packet walk's dragon entries gain each rank's launches on the sharded paths
        if e["name"].startswith("packet_traverse[") and e["name"].endswith(",dragon]"):
            mode = e["name"].split("[")[1].split(",")[0]
            e["sharded_launches"] = {k: [r["launches"][mode] for r in ranks] for k, ranks in sharded.items()}
            e["sharded_launches"]["step_2d_gradient_1x2"] = [st["launches"][mode] for st in step_2d]

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"done: teapot frame {frame_s:.3f} s, dragon flagship frame {flag_s:.3f} s, dragon forest frame "
        f"{forest_s:.3f} s, dragon binned frame {dbin_s:.3f} s, teapot mega frame {mega_s:.3f} s, "
        f"teapot binned frame {binned_s:.3f} s on {card}; binned frames with sort_bounces on and off: "
        f"{json.dumps(binned_sorts)}; dragon fwd+bwd frame {gf['seconds']:.3f} s ({gf['ratio_to_forward']:.3f} x "
        f"forward), teapot fit {grads['fit']['seconds_per_step']:.3f} s a step; dragon kd tree (MaxPrims=8) native "
        f"{json.dumps(host['dragon_trees']['config_ini']['native_s'])} s, numpy "
        f"{json.dumps(host['dragon_trees']['config_ini']['numpy_s'])} s, bit-equal")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
