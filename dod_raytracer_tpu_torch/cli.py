"""Command-line renderer — the reference binary's ``main()`` as a CLI.

``python -m dod_raytracer_tpu_torch.cli [options]`` does what the
reference binary's ``main()`` does (src/main.cpp:349-397): load
``config.ini`` from the working directory, build the default scene (16
random spheres, 6 walls, cylinder, mesh, 9 lights), render, write
``output.png``, with a seeded PRNG instead of ``srand(time(NULL))``
(main.cpp:351).  Counterpart of
``dod_raytracer_tpu.cli`` with the same flags: it renders on the GPU,
or on the CPU with ``--cpu``, and never on the CPU in place of a missing
GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="config.ini", help="reference-format ini file")
    p.add_argument("--output", default="output.png", help="output PNG (main.cpp:396)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--seed", type=int, default=0, help="scene PRNG seed")
    p.add_argument("--mesh", default="teapot",
                   help="'teapot', 'dragon' (procedural stand-in), a path, or 'none'")
    p.add_argument("--no-kdtree", action="store_true")
    p.add_argument("--depth", type=int, default=10, help="bounce depth (main.cpp:301)")
    p.add_argument("--cpu", action="store_true", help="render on the CPU (default: the GPU)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="turn the tracer on and write a torch.profiler chrome trace (CPU and CUDA "
                        "activity, with the tracer's spans) and the spans and counters (spans.json) into DIR")
    args = p.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("dod_raytracer_tpu_torch.cli: no CUDA device; pass --cpu to render on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    from . import native
    from .config import Config
    from .io import write_png
    from .render import quantize_u8, render_image
    from .scene import default_scene
    from .utils import profiling
    from .utils.profiling import log_render_stats, span

    overrides = {}
    if args.width:
        overrides["Width"] = args.width
    if args.height:
        overrides["Height"] = args.height
    overrides["use_kdtree"] = not args.no_kdtree
    overrides["recursion_depth"] = args.depth
    cfg = Config.load(args.config if os.path.exists(args.config) else None, **overrides)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    prof = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        profiling.enable()

    try:
        t0 = time.perf_counter()
        with span("scene_build"):
            mesh = None if args.mesh == "none" else args.mesh
            scene = default_scene(seed=args.seed, cfg=cfg, mesh=mesh).build(cfg, device=device)
            sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with span("render"):
            img = render_image(scene, cfg, device=device)
            sync()
        dt = time.perf_counter() - t0
        with span("png_write"):
            write_png(args.output, quantize_u8(img))
    finally:
        if prof is not None:
            profiling.disable()

    if prof is not None:
        sync()
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        rec = profiling.take()
        with open(os.path.join(args.profile, "spans.json"), "w") as f:
            json.dump({"spans": [dataclasses.asdict(s) for s in rec["spans"]], "counters": rec["counters"]}, f)
    rays = cfg.Width * cfg.Height
    log_render_stats(rays, dt)
    if scene.kd is not None:
        print(f"built the scene in {build_s:.3f}s (kd builder: "
              f"{'native' if native.loaded('kdtree_build') else 'numpy'})")
    print(f"rendered {cfg.Width}x{cfg.Height} in {dt:.3f}s "
          f"({rays / dt / 1e6:.2f} Mprimary-rays/s) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
