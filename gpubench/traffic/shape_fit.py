"""Traffic ``shape_fit``: Adam steps of a shape fit, back to back.

The fitted parameters are a welded mesh's joined vertex positions, the
program's leaf 'triangles.positions': every step derives the corners and
smooth normals from them, renders, and moves them, and the program keeps
its kd tree conservative as they move.  Colours and lights stay fixed.

Set-up makes the scene's inputs from the seed and reads the mesh as the
reference's import holds it (joined positions and faces), builds the
program's scene at the true positions and renders the target with the
program's ``grad.render_for_grad``, then builds the start scene (each
coordinate of the true positions plus N(0, sigma), sigma a share of the
mesh's box diagonal, drawn from the seed) and one optimizer
(``train.make_optimizer``, ``train.make_update_fn``).  That one object is
driven through its first ``setup_steps`` steps by the window's own call,
and then handed to the window, which continues the fit step after step.
One step is one call of ``update``; its loss (``image_loss``: the mean
squared error of the image clamped to [0, 1], as the reference binary
shows it) is read back to the host.
Under ``--trace 1`` the program's tracer is on from ``begin`` to ``end``
and the forward and the backward each end in a synchronize, for the
per-layer readers (``host``).

``correct``: the plain reference (``reference/shape_fit.py``) takes about
9.5 s a 1080p step on the H100, so following a window's ~73 steps would
take some 700 s, over the 150 s a check may spend.  It takes the
program's own state (positions, Adam's moments and step count) before
step 1 and before every ``compare_every``-th step after it (8: steps 1,
9, 17, ..., about 85 s), and from there computes the step's loss,
gradient and Adam update itself.  Three
numbers, as ``fit``'s: the largest relative gap of a compared step's
loss; the gap of the first gradient's norm (the program's from its
optimizer's first moment after step 1) over the joined positions outside
the 1% with the largest gradient on either side (``trimmed_gap``); and
the worst compared step's
gap of the norm of the positions' change, each gap over the reference's
norm.  Then the program renders a frame at its own final positions, and
the reference renders ``check_pixels`` pixels of it (drawn from the seed)
at the same positions: ``px_off_pct`` and ``mean_abs_u8`` as the frames
cell's.  This last check is the direct guard of the tree under motion.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gpubench.reference import render as ref
from gpubench.reference import shape_fit as ref_shape
from gpubench.scenes import inputs
from gpubench.scenes.objreader import parse_obj

UNIT = "step"
LEAF = "triangles.positions"


def welded_mesh(scene_cfg: dict):
    """(positions (V, 3) f32, faces (F, 3) i64) of the configuration's mesh
    file, joined exactly (the reference's JoinIdenticalVertices), after
    checking the file's SHA-256."""
    path = os.path.join(inputs.ROOT, scene_cfg["mesh_file"])
    if inputs.sha256(path) != scene_cfg["mesh_sha256"]:
        raise RuntimeError(f"{scene_cfg['mesh_file']}: SHA-256 differs from the configuration's: the input changed")
    verts, faces, _ = parse_obj(path)
    uniq, inverse = np.unique(verts, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inverse.astype(np.int64).reshape(-1)[faces]


def start_positions(positions: np.ndarray, seed: int, sigma_share: float) -> np.ndarray:
    """The fit's start: each coordinate plus N(0, sigma) from the seed,
    sigma = ``sigma_share`` of the mesh's box diagonal."""
    diag = float(np.linalg.norm(positions.max(axis=0) - positions.min(axis=0)))
    rng = np.random.default_rng([seed, 3])
    return (positions + rng.normal(0.0, sigma_share * diag, positions.shape)).astype(np.float32)


def shown(img):
    """The image as the reference binary shows it before quantising: each
    channel clamped to [0, 1] (``main.cpp:168-171``)."""
    return torch.clamp(img, 0.0, 1.0)


def image_loss(img, target):
    """The fit's loss: the mean squared error of the shown image against the
    shown target.  Unclamped, light 0 at (0, 0, -2), on the teapot's
    surface, sends a few pixels' radiance towards 1/d^2 (over 1,000 in a
    1080p frame), and they alone would make the loss and its gradient."""
    return torch.mean((shown(img) - target) ** 2)


def sample_pixels(seed: int, n_pixels: int, k: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n_pixels, size=min(k, n_pixels), replace=False))


def norm_gap(got: float, want: float) -> float:
    """|got - want| / want; inf where either is not finite."""
    gap = abs(got - want) / max(abs(want), 1e-30)
    return gap if np.isfinite(gap) else float("inf")


def trimmed_gap(got, want, share: float = 0.01) -> float:
    """``norm_gap`` of two (V, 3) gradients over the rows outside the
    ``share`` with the largest norm on either side.  A ray that meets a
    triangle's edge or a silhouette may take the other triangle, or miss,
    in the program and in the reference (Plucker signs against the
    barycentric test); at a grazing hit, or near light 0 on the teapot's
    surface, that one pixel's gradient can outweigh the rest (the whole
    norm read 45% apart on one seed on the H100), while a fault of the
    gradient moves the bulk."""
    g, w = (torch.as_tensor(x, dtype=torch.float64) for x in (got, want))
    gn, wn = torch.linalg.vector_norm(g, dim=1), torch.linalg.vector_norm(w, dim=1)
    k = int(np.ceil(share * g.shape[0]))
    keep = torch.ones(g.shape[0], dtype=torch.bool)
    keep[torch.topk(gn, k).indices] = False
    keep[torch.topk(wn, k).indices] = False
    return norm_gap(float(torch.linalg.vector_norm(g[keep])), float(torch.linalg.vector_norm(w[keep])))


def image_gap(want_u8: np.ndarray, got_u8: np.ndarray, off_u8: int) -> dict:
    gap = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return {"px_off_pct": 100.0 * float((gap.max(axis=-1) > off_u8).mean()), "mean_abs_u8": float(gap.mean())}


class Traffic:
    unit = UNIT

    def __init__(self, port, config, workload, seed, device, spans, overrides=None):
        import dod_raytracer_tpu_torch.grad as port_grad
        import dod_raytracer_tpu_torch.train as port_train
        from dod_raytracer_tpu_torch.utils import profiling

        self.port, self.grad, self.train, self.profiling = port, port_grad, port_train, profiling
        overrides = dict(overrides or {})
        # keys of the workload's parameters among the overrides (CPU tests) replace them
        self.params = {**workload["params"], **{k: overrides.pop(k) for k in list(overrides)
                                                 if k in workload["params"]}}
        self.config, self.seed, self.device, self.spans = config, seed, device, spans
        p = self.params
        size = {"Width": p["width"], "Height": p["height"], "remat_bounces": bool(p["remat_bounces"])}
        self.cfg = port.Config(**{**config["render"], **config["program"], **size, **overrides})
        self.host: dict = {}
        self.work: dict = {}
        self.losses: list = []
        self.traced = False
        self.marks: list = []  # (step start, loss ready, optimizer step) host ns, traced runs
        self.step_ms: list = []  # each window step's host ms, loss read back included
        self.rebuilt: list = []  # the steps whose kd upkeep filed the lanes again (new filing boxes)

    def _builder(self, positions):
        b = inputs.to_builder(self.port, self.arrays)
        b.add_welded_mesh(positions, self.faces, inputs.MESH_COLOR)
        return b

    def _loss(self, scene, target):
        loss = image_loss(self.grad.render_for_grad(scene, self.cfg), target)
        if self.traced:
            torch.cuda.synchronize()
            self.marks[-1].append(time.time_ns())
        return loss

    def _optimizer_step(self, *_):
        if self.traced:
            torch.cuda.synchronize()
            self.marks[-1].append(time.time_ns())

    def setup(self) -> None:
        p = self.params
        with self.spans("inputs"):
            self.arrays = {**inputs.scene_arrays(self.config["scene"], self.seed),
                           "mesh_color": np.array([inputs.MESH_COLOR], np.float32)}
            self.truth, self.faces = welded_mesh(self.config["scene"])
            self.start = start_positions(self.truth, self.seed, float(p["sigma"]))
        with self.spans("scene_build"):
            truth = self._builder(self.truth).build(self.cfg, device=self.device)
        with self.spans("target"), torch.no_grad():
            self.target = shown(self.grad.render_for_grad(truth, self.cfg))
        del truth
        with self.spans("start_build"):
            self.scene = self._builder(self.start).build(self.cfg, device=self.device)
        with self.spans("optimizer"):
            self.opt = self.train.make_optimizer(float(p["lr"]))(self.grad.split_float_params(self.scene, [LEAF]))
            self.opt.register_step_pre_hook(self._optimizer_step)
            self.update = self.train.make_update_fn(self.cfg, [LEAF], loss_fn=self._loss)
        self.states: list = []  # (step, positions, exp_avg, exp_avg_sq) before each compared step
        self.after: dict = {}  # step -> positions after each compared step
        with self.spans("setup_steps"):
            for _ in range(int(p["setup_steps"])):
                self.step()
        self.setup_losses = len(self.losses)

    def begin(self, traced: bool) -> None:
        self.traced = traced and torch.device(self.device).type == "cuda"
        self.marks.clear()
        self.step_ms.clear()
        self.rebuilt.clear()
        if self.traced:
            self.profiling.enable()
            self.profiling.take()

    def step(self) -> None:
        k = len(self.losses) + 1  # this step's number, from 1
        param = self.opt.param_groups[0]["params"][0]
        compared = (k - 1) % int(self.params["compare_every"]) == 0
        if compared:
            st = self.opt.state[param]
            self.states.append((k, self.scene.triangles.positions.detach().clone(), st["exp_avg"].clone(),
                                st["exp_avg_sq"].clone()))
        lanes = self.scene.kd.lane_lo
        t0 = time.perf_counter()
        with self.spans("shape.update"):
            if self.traced:
                self.marks.append([time.time_ns()])
            loss, self.scene, self.opt = self.update(self.scene, self.opt, self.target)
            self.losses.append(float(loss))
        self.step_ms.append(round(1e3 * (time.perf_counter() - t0), 3))
        if self.scene.kd.lane_lo is not lanes:
            self.rebuilt.append(k)
        if k == 1:
            self.first_grad = (self.opt.state[param]["exp_avg"] / (1 - 0.9)).detach().cpu()
        if compared:
            self.after[k] = self.scene.triangles.positions.detach().clone()

    def end(self) -> None:
        if self.traced:
            self.host["counters"] = self.profiling.take()["counters"]
            self.profiling.disable()
            self.host["forward_s"] = [(m[1] - m[0]) / 1e9 for m in self.marks if len(m) == 3]
            self.host["backward_s"] = [(m[2] - m[1]) / 1e9 for m in self.marks if len(m) == 3]
        self.host["steps"] = len(self.losses) - self.setup_losses
        self.host["pixels"] = self.cfg.Width * self.cfg.Height
        p = self.params
        self.pix = sample_pixels(self.seed, self.cfg.Width * self.cfg.Height, int(p["check_pixels"]))
        with torch.no_grad():
            img = self.port.render_image(self.scene, self.cfg, device=self.device)
        u8 = self.port.quantize_u8(img).reshape(-1, 3)
        self.final_u8 = u8[self.pix]
        self.final = self.scene.triangles.positions.detach().cpu().numpy()
        self.states = [(k, *(x.cpu() for x in xs)) for k, *xs in self.states]
        self.after = {k: x.cpu() for k, x in self.after.items()}

    def release(self) -> None:
        self.scene = self.opt = self.target = self.update = None

    def check(self) -> tuple:
        """-> (numbers {name: (value, limit)}, units failed: window steps whose loss is not finite)."""
        got = {"losses": self.losses, "first": self.first_grad, "states": self.states, "after": self.after,
               "final": self.final, "final_u8": self.final_u8}
        nums = compare(self.arrays, self.truth, self.faces, got, self.cfg, self.params, self.pix, self.device)
        limits = self.params["limits"]
        window = self.losses[self.setup_losses:]
        return {k: (nums[k], limits[k]) for k in limits}, sum(not np.isfinite(x) for x in window)

    def diagnostics(self) -> dict:
        return {"losses": self.losses, "compared_steps": [k for k, *_ in self.states], "step_ms": self.step_ms,
                "rebuilt_steps": self.rebuilt}


def compare(arrays, truth, faces, got: dict, cfg, params: dict, pix, device, dtype=torch.float32,
            share: float = 1.0) -> dict:
    """The compared numbers of a fit's record ``got`` (``losses`` by step,
    ``first`` gradient, ``states`` before and ``after`` each compared
    step, ``final`` positions and the frame's ``final_u8`` at ``pix``)
    against the reference at ``cfg``'s size, in ``dtype``."""
    w, h, depth = cfg.Width, cfg.Height, cfg.recursion_depth
    if any(pos.shape != truth.shape for _, pos, _, _ in got["states"]) or got["final"].shape != truth.shape:
        # the fitted leaf is not one row per joined position (a corner soup, say): nothing to compare
        return {k: float("inf") for k in ("loss_gap", "grad1_gap", "change_gap", "px_off_pct", "mean_abs_u8")}
    s = ref_shape.ShapeScene(arrays, truth, faces, cfg.Epsilon, device, dtype)
    target = torch.clamp(ref_shape.image(s, w, h, depth), 0.0, 1.0)
    lr = float(params["lr"])
    loss_gap, change_gap, first = 0.0, 0.0, None
    for k, pos, m, v in got["states"]:
        pos, m, v = (x.to(device=device, dtype=dtype) for x in (pos, m, v))
        loss, g = ref_shape.loss_and_grad(s, pos, target, w, h, depth, share)
        if k == 1:
            first = g.float().cpu()
        moved, _, _ = ref_shape.adam_step(pos, g, m, v, k, lr)
        want = float(torch.linalg.vector_norm((moved - pos).float()))
        change = float(torch.linalg.vector_norm(got["after"][k].float() - pos.float().cpu()))
        change_gap = max(change_gap, norm_gap(change, want))
        loss_gap = max(loss_gap, norm_gap(got["losses"][k - 1], loss))
    s.set_positions(torch.as_tensor(got["final"], device=device).to(dtype))
    want_u8 = ref.quantize_u8(ref_shape.image(s, w, h, depth, torch.as_tensor(pix, device=device))).cpu().numpy()
    return {"loss_gap": loss_gap, "grad1_gap": trimmed_gap(got["first"], first), "change_gap": change_gap,
            **image_gap(want_u8, got["final_u8"], int(params["off_u8"]))}


def reference_fit(arrays, truth, faces, start, cfg, params: dict, steps: int, device, dtype, pix,
                  share: float = 1.0) -> dict:
    """A fit of ``steps`` steps by the reference itself in ``dtype``, from
    ``start``, recorded as the traffic records the program's."""
    w, h, depth = cfg.Width, cfg.Height, cfg.recursion_depth
    s = ref_shape.ShapeScene(arrays, truth, faces, cfg.Epsilon, device, dtype)
    target = torch.clamp(ref_shape.image(s, w, h, depth), 0.0, 1.0)
    pos = torch.as_tensor(start, device=device).to(dtype)
    m, v = torch.zeros_like(pos), torch.zeros_like(pos)
    got = {"losses": [], "states": [], "after": {}}
    for k in range(1, steps + 1):
        compared = (k - 1) % int(params["compare_every"]) == 0
        if compared:
            got["states"].append((k, pos.float().cpu(), m.float().cpu(), v.float().cpu()))
        loss, g = ref_shape.loss_and_grad(s, pos, target, w, h, depth, share)
        if k == 1:
            got["first"] = g.float().cpu()
        pos, m, v = ref_shape.adam_step(pos, g, m, v, k, float(params["lr"]))
        got["losses"].append(loss)
        if compared:
            got["after"][k] = pos.float().cpu()
    got["final"] = pos.float().cpu().numpy()
    s.set_positions(pos)
    got["final_u8"] = ref.quantize_u8(ref_shape.image(s, w, h, depth, torch.as_tensor(pix, device=device))).cpu().numpy()
    return got


def control(config: dict, workload: dict, seed: int, device, dtype, fault: str = "") -> dict:
    """The compared numbers of the reference computed in ``dtype`` put in
    the program's place, at the cell's own size, over ``control_steps``
    steps.  ``fault="half_batch"``: that reference takes its loss over
    half of the pixels."""
    from types import SimpleNamespace

    p = workload["params"]
    cfg = SimpleNamespace(**{**config["render"], "Width": p["width"], "Height": p["height"]})
    arrays = {**inputs.scene_arrays(config["scene"], seed), "mesh_color": np.array([inputs.MESH_COLOR], np.float32)}
    truth, faces = welded_mesh(config["scene"])
    start = start_positions(truth, seed, float(p["sigma"]))
    pix = sample_pixels(seed, cfg.Width * cfg.Height, int(p["check_pixels"]))
    share = 0.5 if fault == "half_batch" else 1.0
    got = reference_fit(arrays, truth, faces, start, cfg, p, int(p["control_steps"]), device, dtype, pix, share)
    return compare(arrays, truth, faces, got, cfg, p, pix, device)
