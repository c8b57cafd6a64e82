#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``dod_raytracer_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed with its elapsed seconds as it ends:
  1. the card (nvidia-smi name and power limit) and the torch version;
  2. build of the CUDA kd-traversal kernel from csrc/ with plain nvcc;
  3. the reference scene from config.ini (1920x1080): 16 spheres, 6 walls,
     the cylinder, the teapot (6,320 triangles), 9 lights, 10 bounces, with
     the kd-tree shape MaxPrims=96, leaf_chunk_lanes=48;
  4. one warm and one timed 1920x1080 frame through ``render_image``;
     the kernel's launch counts are set to 0 just before the timed frame
     and read just after; the image must be finite, of the right shape and
     not black; a 64x32 frame on the card must match the CPU path;
  5. parity of the kernel against the plain walk and against brute force,
     on the triangle queries at bounce 0 and a later bounce of the ray tile
     whose primary rays hit the teapot most, and on the shadow rays of
     those bounces;
  6. the kernel's time per launch at the main path's shapes, the plain
     walk's time on the same inputs, and the least time the card could
     take (bytes over 3.35 TB/s or the edge-sign FMAs of the non-empty
     slots of the tested blocks over 67 TFLOP/s, whichever is larger),
     printed as one ``kernels`` JSON line;
  7. one profiled frame: device time by kernel, the traversal kernel's
     share of it, and the device's idle share, as one ``profile`` line;
  8. the result line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without a result
line; so does a run without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = "dod_raytracer_tpu/ops/pallas/packet_kernel.py:498"
SOURCE = "dod_raytracer_tpu_torch/csrc/packet_traverse.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
LATER_BOUNCE = 3
SHADOW_POINTS = 65536  # hit points per parity bounce whose shadow rays are checked
MASK_AGREEMENT = 0.99999
T_RTOL = 1e-3  # Plücker vs Möller–Trumbore rounding (plucker_kernel.py:18-21)
TIE_RTOL = 1e-5  # a prim may differ only at a tie (tests/test_packet.py:49-63)
RAY_CHUNK = 32768  # rays per brute-force call (bounds its (rays, 2048, 3) temporaries)

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


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after two warm calls."""
    fn()
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


def wall_ms(torch, fn) -> float:
    """Milliseconds of one call (host clock, synchronized on both sides)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from dod_raytracer_tpu_torch import Config, default_scene, quantize_u8, render_image
    from dod_raytracer_tpu_torch.intersect import closest_families, closest_hit, occluded_families
    from dod_raytracer_tpu_torch.ops import packet
    from dod_raytracer_tpu_torch.ops.traverse import _stack_depth, traverse_plain
    from dod_raytracer_tpu_torch.ops.triangle import (brute_force_closest, mt_single,
                                                      occluded_triangles_brute)
    from dod_raytracer_tpu_torch.render import frame_rays
    from dod_raytracer_tpu_torch.shading import light_terms, shadow_rays
    from dod_raytracer_tpu_torch.utils.math import reflect

    dev = torch.device(device)

    # ---- 1. the card ----
    card = card_line()
    print(card, flush=True)
    log(f"phase 1 card: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. kernel build ----
    built = packet.build(force=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print("  ptxas:", line.strip(), flush=True)
    packet._library()
    log(f"phase 2 build: nvcc {built['seconds']:.2f} s -> {os.path.relpath(built['path'], ROOT)}")

    # ---- 3. scene ----
    t = time.perf_counter()
    cfg = Config.load(os.path.join(ROOT, "config.ini"), MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0)
    scene = default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device=dev)
    torch.cuda.synchronize()
    kd = scene.kd
    log(f"phase 3 scene: {cfg.Width}x{cfg.Height}, {scene.n_triangles} triangles, "
        f"{kd.node_flag.shape[0]} nodes, {kd.block_g.shape[0]} blocks of {kd.block_orig.shape[1]} slots, "
        f"{scene.n_spheres} spheres, {scene.n_planes} planes, {scene.n_cylinders} cylinder, "
        f"{scene.n_lights} lights, depth {cfg.recursion_depth}, built in {time.perf_counter() - t:.2f} s")

    # ---- 4. frames ----
    t = time.perf_counter()
    render_image(scene, cfg, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    packet.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    img = render_image(scene, cfg, device=dev)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t
    counts = dict(packet.launches)
    check(counts["closest"] > 0 and counts["any_hit"] > 0, f"kernel not launched on the main path: {counts}")
    check(tuple(img.shape) == (cfg.Height, cfg.Width, 3), f"frame shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "frame has non-finite values")
    mean = float(img.mean())
    check(mean > 0.01, f"frame is black (mean {mean})")
    pixels = cfg.Width * cfg.Height
    log(f"phase 4 frame: warm {warm_s:.3f} s, timed {frame_s:.3f} s, {pixels / frame_s:.0f} primary rays/s, "
        f"mean {mean:.4f}, launches {counts}")

    # a small frame on the card (kernel) against the CPU path (plain walk)
    small = Config.load(os.path.join(ROOT, "config.ini"), Width=64, Height=32,
                        MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0)
    img_gpu = render_image(default_scene(seed=0, cfg=small, mesh="teapot").build(small, device=dev),
                           small, device=dev)
    img_cpu = render_image(default_scene(seed=0, cfg=small, mesh="teapot").build(small, device="cpu"),
                           small, device="cpu")
    far = float((img_gpu.cpu() - img_cpu).abs().gt(2e-3).float().mean())
    u8 = (quantize_u8(img_gpu).astype(int) - quantize_u8(img_cpu).astype(int))
    u8_off = float((abs(u8) > 1).mean())
    check(u8_off < 0.01, f"64x32 frame: {u8_off:.4%} of u8 channels differ by more than 1 from the CPU path")
    log(f"phase 4 small frame vs CPU path: {far:.4%} of channels off by > 2e-3, "
        f"{u8_off:.4%} of u8 channels off by > 1")

    # ---- 5. parity ----
    depth = _stack_depth(kd, cfg)
    verts = scene.triangles.verts

    def brute_closest(o, d):
        parts = [brute_force_closest(verts, o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK])
                 for s in range(0, o.shape[0], RAY_CHUNK)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    def brute_any(o, d, tm):
        return torch.cat([occluded_triangles_brute(verts, o[s:s + RAY_CHUNK], d[s:s + RAY_CHUNK],
                                                   tm[s:s + RAY_CHUNK])
                          for s in range(0, o.shape[0], RAY_CHUNK)])

    def mt_t_of(prim, o, d):
        tri = verts[prim.long()]
        return mt_single(tri, o, d, torch.ones(o.shape[0], dtype=torch.bool, device=dev))[0]

    def allowed(n):
        return math.floor(n * (1.0 - MASK_AGREEMENT))

    def check_closest(label, o, d, tt):
        tk, pk, fk = packet.packet_traverse(kd, o, d, tt, depth, False)
        tp, pp, fp = traverse_plain(kd, o, d, tt, depth, False)
        tb, pb = brute_closest(o, d)
        hk = fk & (tk < tt)
        res = {}
        for name, tr, pr, hr in (("plain", tp, pp, fp & (tp < tt)), ("brute", tb, pb, tb < tt)):
            n = o.shape[0]
            mism = int((hk != hr).sum())
            both = hk & hr
            t_bad = int((both & ((tk - tr).abs() > T_RTOL * tr.abs())).sum())
            flip = both & (pk != pr)
            nflip = int(flip.sum())
            bad_flip = 0
            if nflip:
                ta, tb2 = mt_t_of(pk[flip], o[flip], d[flip]), mt_t_of(pr[flip], o[flip], d[flip])
                bad_flip = int(((ta - tb2).abs() > TIE_RTOL * tb2.abs()).sum())
            err = float((tk - tr)[both].abs().max()) if bool(both.any()) else 0.0
            res[name] = dict(rays=n, hits=int(hr.sum()), mask_mismatch=mism, t_out_of_rtol=t_bad,
                             prim_flips=nflip, bad_flips=bad_flip, max_abs_t_err=err)
            check(mism <= allowed(n) and t_bad == 0 and bad_flip == 0,
                  f"closest parity {label} vs {name}: {res[name]}")
        log(f"phase 5 parity closest {label}: {json.dumps(res)}")
        return res

    def check_any(label, o, d, tt):
        _, _, fk = packet.packet_traverse(kd, o, d, tt, depth, True)
        _, _, fp = traverse_plain(kd, o, d, tt, depth, True)
        fb = brute_any(o, d, tt)
        res = {}
        for name, fr in (("plain", fp), ("brute", fb)):
            n = o.shape[0]
            mism = int((fk != fr).sum())
            res[name] = dict(rays=n, live=int((tt > 0).sum()), occluded=int(fr.sum()), mask_mismatch=mism)
            check(mism <= allowed(n), f"any-hit parity {label} vs {name}: {res[name]}")
        log(f"phase 5 parity any-hit {label}: {json.dumps(res)}")
        return res

    # the ray tile whose primary rays hit the teapot most often
    o_all, d_all, raw_all, _, tile = frame_rays(cfg, dev)
    t_inf = torch.full((o_all.shape[0],), float("inf"), device=dev)
    t_tri = torch.minimum(closest_families(scene, o_all, d_all, cfg, t_inf).t, t_inf)
    tk, _, fk = packet.packet_traverse(kd, o_all, d_all, t_tri, depth, False)
    start = int((fk & (tk < t_tri)).reshape(-1, tile).sum(1).argmax()) * tile
    o, d, raw = (x[start:start + tile] for x in (o_all, d_all, raw_all))
    log(f"phase 5 parity tile: rays [{start}, {start + tile}) of {o_all.shape[0]}")
    active = torch.ones(tile, dtype=torch.bool, device=dev)
    parity = {}
    timing_inputs = {}
    for k in range(LATER_BOUNCE + 1):
        t_max = torch.where(active, float("inf"), -1.0)
        t_tri = torch.minimum(closest_families(scene, o, d, cfg, t_max).t, t_max)
        if k in (0, LATER_BOUNCE):
            parity[f"closest_b{k}"] = check_closest(f"bounce {k}", o, d, t_tri)
        if k == 0:
            timing_inputs["closest"] = (o, d, t_tri)
        hit = closest_hit(scene, o, d, cfg, t_max=t_max)
        active = active & hit.mask
        if k in (0, LATER_BOUNCE):
            n_pts = SHADOW_POINTS if k else tile  # bounce 0: the whole tile, as the main path batches it
            shade, _ = light_terms(scene, hit.point[:n_pts], hit.normal[:n_pts], raw[:n_pts])
            so, sd, st = shadow_rays(scene, hit.point[:n_pts], active[:n_pts], shade > 0.0)
            st = torch.where(occluded_families(scene, so, sd, st, cfg), -1.0, st)
            if k == 0:
                timing_inputs["any_hit"] = (so, sd, st)
                n_sub = min(SHADOW_POINTS, tile)
                sel = torch.cat([torch.arange(li * tile, li * tile + n_sub, device=dev)
                                 for li in range(scene.lights.position.shape[0])])
                so, sd, st = so[sel], sd[sel], st[sel]
            parity[f"any_b{k}"] = check_any(f"bounce {k}", so.contiguous(), sd.contiguous(), st.contiguous())
        d_new = reflect(d, hit.normal)
        o = torch.where(active[:, None], hit.point + d_new * cfg.Epsilon, o)
        d = torch.where(active[:, None], d_new, d)

    # ---- 6. kernel times and bounds ----
    S = kd.block_orig.shape[1]
    table_bytes = (kd.node_flag.shape[0] * 20 + 24 + kd.block_aabb.numel() * 4
                   + kd.block_g.numel() * 4 + kd.block_tris.numel() * 4 + kd.block_orig.numel() * 4)
    kernels = []
    for mode in ("closest", "any_hit"):
        any_hit = mode == "any_hit"
        ko, kdir, kt = (x.contiguous() for x in timing_inputs[mode])
        n = ko.shape[0]
        ms = time_ms(torch, lambda: packet.packet_traverse(kd, ko, kdir, kt, depth, any_hit), 20)
        plain_ms = wall_ms(torch, lambda: traverse_plain(kd, ko, kdir, kt, depth, any_hit))
        # a measurement-only build of the kernel counts the work of these inputs
        stats = torch.zeros((n, 3), dtype=torch.int32, device=dev)
        packet.packet_traverse(kd, ko, kdir, kt, depth, any_hit, stats=stats)
        node_steps, blocks, slots = (int(x) for x in stats.sum(0, dtype=torch.int64))
        nbytes = n * (12 + 12 + 4) + n * 12 + table_bytes  # o, d, t_max in; t, prim, found out
        flops = slots * 18 * 2  # edge-sign FMAs of the non-empty slots of the blocks that pass their AABB
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        key = "closest_b0" if mode == "closest" else "any_b0"
        if mode == "closest":
            err = parity[key]["plain"]["max_abs_t_err"]
        else:
            err = float(parity[key]["plain"]["mask_mismatch"] > 0)
        kernels.append(dict(
            name=f"packet_traverse[{mode}]", route="cuda", source=SOURCE, replaces=REPLACES,
            launches=counts[mode], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, rays=n, node_steps=node_steps, blocks_tested=blocks,
            slots_tested=slots, padded_slots_of_tested_blocks=blocks * S,
            parity={"bounce0": parity[key], f"bounce{LATER_BOUNCE}":
                    parity["closest_b3" if mode == "closest" else "any_b3"]}))
        log(f"phase 6 {mode}: {n} rays, {ms:.3f} ms/launch (plain {plain_ms:.1f} ms), "
            f"bound {max(t_bytes, t_ops):.4f} ms ({kernels[-1]['bound_by']}), "
            f"{node_steps} node steps, {blocks} blocks tested, {slots} non-empty slots tested "
            f"of {blocks * S} slots in those blocks")

    # ---- 7. where one frame's device time goes ----
    from torch.profiler import ProfilerActivity, profile

    launches_before = sum(packet.launches.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        render_image(scene, cfg, device=dev)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    launches_per_frame = sum(packet.launches.values()) - launches_before
    dev_ms = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op records repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            dev_ms[e.key] = dev_ms.get(e.key, 0.0) + us / 1e3
    busy = sum(dev_ms.values())
    if busy > 0:
        ours = sum(v for k, v in dev_ms.items() if "packet_traverse_kernel" in k)
        top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({"profile": {
            "frame_wall_ms": prof_wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / prof_wall_ms),
            "traversal_kernel_ms": ours, "traversal_share_of_busy": ours / busy,
            "traversal_launches": launches_per_frame,
            "top": [{"name": k[:90], "ms": v} for k, v in top]}}), flush=True)
    else:
        print(json.dumps({"profile": "not measured: the profiler recorded no device time"}), flush=True)
    log("phase 7 profile")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"done: frame {frame_s:.3f} s on {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
