#!/usr/bin/env python
"""Inverse-rendering demo on the PyTorch port: recover scene parameters
from a target image.

Renders a ground-truth scene (two spheres, two planes, two lights; 96x64,
3 bounces, no kd tree), perturbs the sphere albedos and the first light's
intensity, then runs 60 Adam steps (lr 0.08) of ``train.fit`` on the pixel
MSE back toward the target, through torch autograd.  Writes target /
initial / recovered PNGs and prints the loss and the parameter errors.
The counterpart of ``examples/inverse_rendering.py``.

Run on the GPU:   python examples/inverse_rendering_torch.py
Run on the CPU:   python examples/inverse_rendering_torch.py --cpu
Without a GPU and without ``--cpu`` it exits 2.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the GPU)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--outdir", default="inverse_demo_torch")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("inverse_rendering_torch: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    from dod_raytracer_tpu_torch import Config, quantize_u8, render_image
    from dod_raytracer_tpu_torch.io import write_png
    from dod_raytracer_tpu_torch.scene import SceneBuilder
    from dod_raytracer_tpu_torch.train import fit

    cfg = Config(Width=args.width, Height=args.height, use_kdtree=False, recursion_depth=3,
                 ray_tile=args.width * args.height)

    def build(colors, intensity):
        b = SceneBuilder()
        b.add_sphere((-1.2, 0.0, 2.5), 1.0, colors[0])
        b.add_sphere((1.2, 0.4, 3.0), 0.9, colors[1])
        b.add_plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0), (0.35, 0.35, 0.4))
        b.add_plane((0.0, 0.0, 6.0), (0.0, 0.0, -1.0), (0.25, 0.3, 0.45))
        b.add_light((0.0, 3.0, -1.0), intensity)
        b.add_light((-2.0, 1.5, 0.5), 1.0)
        return b.build(cfg, device=device)

    true_scene = build([(0.85, 0.2, 0.15), (0.15, 0.4, 0.85)], 3.0)
    with torch.no_grad():
        target = render_image(true_scene, cfg, device=device)

    start_scene = build([(0.4, 0.4, 0.4), (0.4, 0.4, 0.4)], 1.5)
    recovered, losses = fit(
        start_scene, target, cfg,
        params=("spheres.color", "lights.intensity"),
        steps=args.steps, lr=0.08, log_every=10)

    os.makedirs(args.outdir, exist_ok=True)
    with torch.no_grad():
        write_png(os.path.join(args.outdir, "target.png"), quantize_u8(target))
        write_png(os.path.join(args.outdir, "initial.png"), quantize_u8(render_image(start_scene, cfg, device=device)))
        write_png(os.path.join(args.outdir, "recovered.png"), quantize_u8(render_image(recovered, cfg, device=device)))

    c_err = float((recovered.spheres.color[:2] - true_scene.spheres.color[:2]).abs().max())
    i_err = float((recovered.lights.intensity[0] - true_scene.lights.intensity[0]).abs())
    print(f"loss {losses[0]:.4e} -> {losses[-1]:.4e} over {args.steps} steps")
    print(f"max albedo error {c_err:.3f}, light-intensity error {i_err:.3f}")
    print(f"PNGs in {args.outdir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
