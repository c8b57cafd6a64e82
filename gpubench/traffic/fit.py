"""Traffic ``fit``: Adam steps of an inverse-rendering fit, back to back.

Set-up makes the scene's inputs from the seed, builds the program's scene
with the true parameters, renders the target with the program's
``grad.render_for_grad``, then builds the start scene (the fitted
parameters times U(lo, hi) drawn from the seed, colours clipped to
[0, 1]) and one optimizer (``train.make_optimizer``, ``train.make_update_fn``).
That one object is driven through its first ``setup_steps`` steps by the
window's own call, and then handed to the window, which continues the fit
step after step.  One step is one call of ``update``; its loss is read
back to the host.

``correct``: once the window has closed and the program's state is
freed, the plain reference (``reference/fit.py``) follows the whole fit
from the same inputs: the set-up steps and every step of the window.
Three numbers: the largest relative gap of a step's loss, over all steps;
and, by the worst leaf, the gap between the program's and the reference's
norms of the first gradient (from the optimizer's first moment after step
1) and of the parameters' change over the whole fit, each over the larger
of the reference's norm of that leaf and the median leaf's.  A leaf whose
reference gradient is under a thousandth of the median leaf's is left out
of the last two.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from gpubench.reference import fit as ref_fit
from gpubench.reference import render as ref
from gpubench.scenes import inputs

UNIT = "step"
LEAVES = (("sphere_color", True), ("mesh_color", True), ("light_intensity", False))  # (input, clipped to [0, 1])


class _BackwardStart(torch.autograd.Function):
    """Identity on the loss whose backward notes when the backward began."""

    @staticmethod
    def forward(ctx, loss, marks):
        ctx.marks = marks
        return loss.clone()

    @staticmethod
    def backward(ctx, grad):
        ctx.marks.append(time.time_ns())
        return grad, None


def start_arrays(arrays: dict, seed: int, lo: float, hi: float) -> dict:
    """The fit's start: each fitted input times U(lo, hi) from the seed."""
    rng = np.random.default_rng([seed, 2])
    out = dict(arrays)
    for key, clip in LEAVES:
        x = arrays[key] * rng.uniform(lo, hi, arrays[key].shape).astype(np.float32)
        out[key] = np.clip(x, 0.0, 1.0) if clip else x
    return out


def gap(port_norms: list, ref_norms: list, keep: list) -> float:
    """The worst leaf's |port - ref| over max(ref leaf, median ref leaf)."""
    med = float(np.median(ref_norms))
    return max(abs(p - r) / max(r, med) for p, r, k in zip(port_norms, ref_norms, keep) if k)


class Traffic:
    unit = UNIT

    def __init__(self, port, config, workload, seed, device, spans, overrides=None):
        import dod_raytracer_tpu_torch.grad as port_grad
        import dod_raytracer_tpu_torch.train as port_train

        self.port, self.grad, self.train = port, port_grad, port_train
        self.config, self.params, self.seed, self.device, self.spans = config, workload["params"], seed, device, spans
        p = self.params
        self.names = tuple(p["fit_params"])
        size = {"Width": p["width"], "Height": p["height"], "remat_bounces": bool(p["remat_bounces"])}
        self.cfg = port.Config(**{**config["render"], **config["program"], **size, **(overrides or {})})
        self.host: dict = {}
        self.losses: list = []
        self.bwd_start: list = []
        self.bwd_end: list = []
        self.traced = False

    def _loss(self, scene, target):
        return _BackwardStart.apply(self.grad.mse_loss(scene, target, self.cfg), self.bwd_start)

    def _backward_end(self, *_):
        if self.traced:
            torch.cuda.synchronize()
        self.bwd_end.append(time.time_ns())

    def setup(self) -> None:
        p = self.params
        with self.spans("inputs"):
            mesh = inputs.load_mesh(self.config["scene"])
            self.truth = inputs.scene_arrays(self.config["scene"], self.seed, mesh)
            self.start = start_arrays(self.truth, self.seed, *p["perturb"])
        t0 = time.perf_counter()
        with self.spans("scene_build"):
            truth = inputs.to_builder(self.port, self.truth).build(self.cfg, device=self.device)
            if self.device == "cuda":
                torch.cuda.synchronize()
        self.host["scene_build_s"] = time.perf_counter() - t0
        with self.spans("target"), torch.no_grad():
            self.target = self.grad.render_for_grad(truth, self.cfg)
        del truth
        with self.spans("start_build"):
            self.scene = inputs.to_builder(self.port, self.start).build(self.cfg, device=self.device)
        names = self.names
        with self.spans("optimizer"):
            self.opt = self.train.make_optimizer(float(p["lr"]))(self.grad.split_float_params(self.scene, names))
            self.opt.register_step_pre_hook(self._backward_end)
            self.update = self.train.make_update_fn(self.cfg, names, loss_fn=self._loss)
        with self.spans("setup_steps"):
            for k in range(int(p["setup_steps"])):
                self.step()
                if k == 0:
                    tensors = self.opt.param_groups[0]["params"]
                    self.first_grad = [float(torch.linalg.vector_norm(self.opt.state[t]["exp_avg"] / (1 - 0.9)))
                                       for t in tensors]
        self.setup_losses = list(self.losses)
        self.work: dict = {}

    def begin(self, traced: bool) -> None:
        self.traced = traced
        self.losses.clear()
        self.bwd_start.clear()
        self.bwd_end.clear()

    def step(self) -> None:
        with self.spans("fit.update"):
            loss, self.scene, self.opt = self.update(self.scene, self.opt, self.target)
            self.losses.append(float(loss))

    def end(self) -> None:
        now = self.grad.leaves(self.grad.split_float_params(self.scene, self.names))
        self.change = [float(torch.linalg.vector_norm(x.detach().cpu() - torch.from_numpy(self.start[key])
                                                      .reshape(x.shape)))
                       for x, (key, _) in zip(now, LEAVES)]
        for a, b in zip(self.bwd_start, self.bwd_end):
            self.spans.add("fit.backward", a, b)
        self.host["backward_s"] = [(b - a) / 1e9 for a, b in zip(self.bwd_start, self.bwd_end)]

    def release(self) -> None:
        self.scene = self.opt = self.target = self.update = None

    def check(self) -> tuple:
        """-> (numbers {name: (value, limit)}, units failed: steps whose loss is not finite)."""
        losses = self.setup_losses + self.losses
        want = reference_run(self.truth, self.start, self.cfg, self.params, self.device, torch.float32, len(losses))
        got = numbers({"losses": losses, "first": self.first_grad, "change": self.change}, want)
        limits = self.params["limits"]
        return {k: (got[k], limits[k]) for k in limits}, sum(not np.isfinite(x) for x in self.losses)

    def diagnostics(self) -> dict:
        return {"setup_losses": self.setup_losses, "window_losses_first_last":
                [self.losses[0], self.losses[-1]] if self.losses else []}


def reference_run(truth: dict, start: dict, cfg, params: dict, device, dtype, steps: int,
                  share: float = 1.0) -> dict:
    """The reference's losses, first-gradient norms and change norms over
    ``steps`` steps at ``cfg``'s Width, Height, recursion_depth and Epsilon
    (``share``: see ``reference.fit.fit``)."""
    s = ref.RefScene(truth, cfg.Epsilon, device, dtype)
    with torch.no_grad():
        pix = torch.arange(cfg.Width * cfg.Height, device=device)
        terms = ref.trace(s, ref.primary_dirs(cfg.Width, cfg.Height, pix, device, dtype), cfg.recursion_depth)
        target = ref.shade(terms, s.colors, s.light_i)
    st = [torch.as_tensor(start[k], device=device) for k, _ in LEAVES]
    losses, first, change = ref_fit.fit(s, terms, target, st, float(params["lr"]), steps, share)
    norm = lambda xs: [float(torch.linalg.vector_norm(x.float())) for x in xs]
    return {"losses": losses, "first": norm(first), "change": norm(change)}


def control(config: dict, workload: dict, seed: int, device, dtype, fault: str = "") -> dict:
    """The compared numbers of the reference computed in ``dtype`` put in
    the program's place, at the cell's own size, over ``control_steps``
    steps (as many as a run's set-up and window hold).
    ``fault="half_batch"``: that reference takes its loss over half of the
    pixels."""
    p = workload["params"]
    cfg = SimpleNamespace(**{**config["render"], "Width": p["width"], "Height": p["height"]})
    truth = inputs.scene_arrays(config["scene"], seed, inputs.load_mesh(config["scene"]))
    start = start_arrays(truth, seed, *p["perturb"])
    steps = int(p["control_steps"])
    want = reference_run(truth, start, cfg, p, device, torch.float32, steps)
    share = 0.5 if fault == "half_batch" else 1.0
    return numbers(reference_run(truth, start, cfg, p, device, dtype, steps, share), want)


def numbers(got: dict, want: dict) -> dict:
    """The three compared numbers of ``got`` against ``want``."""
    med = float(np.median(want["first"]))
    keep = [g >= 1e-3 * med for g in want["first"]]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap": loss_gap, "grad1_gap": gap(got["first"], want["first"], keep),
            "change_gap": gap(got["change"], want["change"], keep)}
