"""The plain reference against the program's CPU path at a tiny size."""

import json
import os

import numpy as np
import torch

import dod_raytracer_tpu_torch as port
from gpubench.reference import render as ref
from gpubench.scenes import inputs
from gpubench.traffic import frames

SEED = 2**31 + 99


def teapot_arrays(seed=SEED):
    with open(os.path.join(inputs.ROOT, "gpubench", "configs", "teapot-ref.json")) as f:
        cfg = json.load(f)["scene"]
    return inputs.scene_arrays(cfg, seed, inputs.load_mesh(cfg))


def test_reference_frame_agrees_with_the_programs_cpu_path():
    arrays = teapot_arrays()
    cfg = port.Config(Width=32, Height=16, recursion_depth=3, MaxPrims=96, leaf_chunk_lanes=48, ray_tile=0)
    scene = inputs.to_builder(port, arrays).build(cfg, device="cpu")
    got = port.quantize_u8(port.render_image(scene, cfg, device="cpu"))
    pix = np.arange(32 * 16)
    want = frames.reference_u8(arrays, cfg, pix, "cpu", torch.float32)
    worst, _ = frames.compare(want, [got.reshape(-1, 3)], off_u8=2)
    assert worst["px_off_pct"] == 0.0 and worst["mean_abs_u8"] < 0.01, worst


def test_clusters_find_what_brute_force_finds():
    """The reference's culling drops no hit: its closest and any-hit
    queries equal a brute force over every triangle."""
    arrays = teapot_arrays()
    s = ref.RefScene(arrays, 1e-4, "cpu")
    g = torch.Generator().manual_seed(3)
    o = (torch.rand((512, 3), generator=g) * 8 - 4)
    d = torch.nn.functional.normalize(torch.randn((512, 3), generator=g), dim=1)
    tmax = torch.full((512,), float("inf"))
    t, idx = s.acc.closest(o, d, tmax)
    tri = s.tri
    bt, _, _ = ref._mt(tri[None, :, 0], (tri[:, 1] - tri[:, 0])[None], (tri[:, 2] - tri[:, 0])[None],
                       o[:, None], d[:, None])
    want = bt.amin(dim=1)
    assert torch.equal(t, want)
    hit = torch.isfinite(want)
    assert int(hit.sum()) > 20
    assert torch.equal(bt[hit, idx[hit]], want[hit])
    clip = torch.where(hit, want * 1.5, 3.0)
    assert torch.equal(s.acc.any(o, d, clip), (bt < clip[:, None]).any(dim=1))
