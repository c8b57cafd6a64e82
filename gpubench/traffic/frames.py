"""Traffic ``frames``: whole frames back to back, one client, closed loop.

A frame is the program's ``render_image`` followed by its ``quantize_u8``:
the u8 image on the host, which is what a user of the renderer receives.
Set-up makes the scene's inputs from the seed, builds the program's scene
and renders one warm frame, which also builds every kernel the frame uses.

``correct``: once the window has closed and the program's state is freed,
the plain reference (``reference/render.py``) renders a sample of the
frame's pixels, drawn from the seed, and every frame of the window is
compared with it at those pixels.  Two numbers, each over the worst frame:
the share of sampled pixels whose largest channel gap exceeds
``off_u8`` levels, and the mean gap over the sampled channels.  The
reference's trace of the sample also counts the kd queries its semantics
make a pixel, which ``kd_walk_roofline`` reads.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from gpubench.reference import render as ref
from gpubench.scenes import inputs

UNIT = "frame"


def sample_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def compare(ref_u8: np.ndarray, frames: list, off_u8: int) -> tuple:
    """-> (the worst frame's numbers, each frame's): ``px_off_pct``, the
    share (%) of sampled pixels whose largest channel gap exceeds
    ``off_u8``; ``mean_abs_u8``, the mean gap over the sampled channels."""
    per = []
    for f in frames:
        gap = np.abs(f.astype(np.int32) - ref_u8.astype(np.int32))
        per.append({"px_off_pct": 100.0 * float((gap.max(axis=-1) > off_u8).mean()),
                    "mean_abs_u8": float(gap.mean())})
    worst = {k: max(p[k] for p in per) for k in per[0]}
    return worst, per


class Traffic:
    unit = UNIT

    def __init__(self, port, config, workload, seed, device, spans, overrides=None):
        self.port, self.config, self.params = port, config, workload["params"]
        self.seed, self.device, self.spans = seed, device, spans
        self.cfg = port.Config(**{**config["render"], **config["program"], **(overrides or {})})
        self.frames: list = []
        self.frame_s: list = []
        self.host: dict = {}

    def setup(self) -> None:
        with self.spans("inputs"):
            mesh = inputs.load_mesh(self.config["scene"]) if self.config["scene"].get("mesh_file") else None
            self.arrays = inputs.scene_arrays(self.config["scene"], self.seed, mesh)
            builder = inputs.to_builder(self.port, self.arrays)
        t0 = time.perf_counter()
        with self.spans("scene_build"):
            self.scene = builder.build(self.cfg, device=self.device)
            if self.device == "cuda":
                torch.cuda.synchronize()
        self.host["scene_build_s"] = time.perf_counter() - t0
        with self.spans("warm"):
            for _ in range(int(self.params["warm_frames"])):
                self._frame()
        self.work = {"pixels": self.cfg.Width * self.cfg.Height}

    def _frame(self):
        t0 = time.perf_counter()
        with self.spans("frame"):
            with self.spans("render_image"):
                img = self.port.render_image(self.scene, self.cfg, device=self.device)
            with self.spans("to_host"):
                u8 = self.port.quantize_u8(img)
        self.frame_s.append(time.perf_counter() - t0)
        self.frames.append(u8)

    def begin(self, traced: bool) -> None:
        self.frames.clear()
        self.frame_s.clear()

    def step(self) -> None:
        self._frame()

    def end(self) -> None:
        pass

    def release(self) -> None:
        self.scene = None

    def check(self) -> tuple:
        """-> (numbers {name: (value, limit)}, units failed)."""
        c, p = self.cfg, self.params
        pix = sample_pixels(self.seed, c.Width * c.Height, int(p["check_pixels"]))
        counts: dict = {}
        want = reference_u8(self.arrays, c, pix, self.device, torch.float32, counts)
        self.work.update(closest_per_px=counts["closest"] / len(pix), shadow_per_px=counts["shadow"] / len(pix))
        rows, cols = pix // c.Width, pix % c.Width
        worst, per = compare(want, [f[rows, cols] for f in self.frames], int(p["off_u8"]))
        limits = p["limits"]
        failed = sum(any(x[k] > limits[k] for k in limits) for x in per)
        return {k: (worst[k], limits[k]) for k in limits}, failed

    def diagnostics(self) -> dict:
        f = np.array(self.frame_s)
        q = np.percentile(f, [25, 50, 75])
        return {"frame_s_q1_median_q3": [float(x) for x in q], "frame_s_min_max": [float(f.min()), float(f.max())],
                "frame_s_first3": [float(x) for x in f[:3]]}


def reference_u8(arrays: dict, cfg, pix: np.ndarray, device, dtype, counts: dict = None) -> np.ndarray:
    """(K, 3) u8 colours of the pixels ``pix`` by the plain reference at
    ``cfg``'s Width, Height, recursion_depth and Epsilon (``counts``: see
    ``reference.render.trace``)."""
    s = ref.RefScene(arrays, cfg.Epsilon, device, dtype)
    with torch.no_grad():
        out = ref.render_pixels(s, cfg.Width, cfg.Height, cfg.recursion_depth, torch.from_numpy(pix), counts)
    return out.cpu().numpy()


def control(config: dict, workload: dict, seed: int, device, dtype, fault: str = "") -> dict:
    """The compared numbers of the reference computed in ``dtype`` put in
    the program's place, at the cell's own size and sample.
    ``fault="half_batch"``: half of that reference's pixels left black."""
    p = workload["params"]
    cfg = SimpleNamespace(**config["render"])
    mesh = inputs.load_mesh(config["scene"]) if config["scene"].get("mesh_file") else None
    arrays = inputs.scene_arrays(config["scene"], seed, mesh)
    pix = sample_pixels(seed, cfg.Width * cfg.Height, int(p["check_pixels"]))
    want = reference_u8(arrays, cfg, pix, device, torch.float32)
    got = reference_u8(arrays, cfg, pix, device, dtype)
    if fault == "half_batch":
        got[len(got) // 2:] = 0
    return compare(want, [got], int(p["off_u8"]))[0]
