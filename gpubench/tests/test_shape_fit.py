"""The ``teapot-shape-fit`` cell on the CPU at a tiny size: a sound run is
correct, each fault planted in the program reads not correct, and the
cell's four readers on synthetic contexts.

Faults: a stale tree (the conservativeness check skipped, so a rebuilt
tree never replaces the one the vertices moved away from, at a learning
rate that moves them across split planes), a step that returns its state,
the loss over half the pixels, and corners not welded (each face keeps its
own copy of its corners, so the corner soup is fitted)."""

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as port
import dod_raytracer_tpu_torch.grad as port_grad
import dod_raytracer_tpu_torch.train as port_train
from dod_raytracer_tpu_torch.accel.kdtree import refresh_kd_blocks
from gpubench import devtrace, run

SEED = 2**31 + 2718
SMALL = dict(width=32, height=24, recursion_depth=3, compare_every=2)
# a learning rate of 0.1, some 60x the cell's, and a tree of 8-triangle leaves: steps cross split planes
FAST = dict(SMALL, lr=0.1, MaxPrims=8, leaf_chunk_lanes=8)


def shape_run(overrides=SMALL, seconds=0.5):
    return run.run_cell("teapot-shape-fit", SEED, seconds, False, device="cpu", overrides=dict(overrides))


def test_sound_shape_fit_is_correct():
    r = shape_run()
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["diagnostics"]["compared_steps"][:2] == [1, 3]


def test_fast_moves_with_the_tree_kept_conservative_are_correct():
    r = shape_run(FAST)
    assert r["correct"], r["checks"]


def test_a_stale_tree(monkeypatch):
    monkeypatch.setattr(port_grad, "follow_vertices", lambda kd, old, new: refresh_kd_blocks(kd, new))
    r = shape_run(FAST)
    assert not r["correct"], r["checks"]
    c = r["checks"]
    assert c["px_off_pct"]["value"] > c["px_off_pct"]["limit"] or c["loss_gap"]["value"] > c["loss_gap"]["limit"]


def test_a_step_that_returns_its_state(monkeypatch):
    real = port_train.make_update_fn

    def stuck(cfg, params, loss_fn=None):
        update = real(cfg, params, loss_fn)

        def step(scene, opt, target):
            loss, _, opt = update(scene, opt, target)
            return loss, scene, opt
        return step

    monkeypatch.setattr(port_train, "make_update_fn", stuck)
    r = shape_run()
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == pytest.approx(1.0), r["checks"]


def test_the_loss_over_half_the_pixels(monkeypatch):
    """The program's render hands back the target's own values (no error, no
    gradient) for the lower half of the image, so the loss covers the upper
    half only; the first render is the target's."""
    real, seen = port_grad.render_for_grad, []

    def half(scene, cfg, width=None, height=None):
        img = real(scene, cfg, width, height)
        if not seen:
            seen.append(img.detach().clamp(0.0, 1.0))
            return img
        n = img.shape[0] // 2
        return torch.cat([img[:n], seen[0][n:]])

    monkeypatch.setattr(port_grad, "render_for_grad", half)
    r = shape_run()
    assert not r["correct"] and r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"], r["checks"]


def test_corners_not_welded(monkeypatch):
    real = port.SceneBuilder.add_welded_mesh

    def unwelded(self, positions, faces, color=(0.1, 0.8, 0.3)):
        corners = np.asarray(positions)[np.asarray(faces)].reshape(-1, 3)
        return real(self, corners, np.arange(corners.shape[0]).reshape(-1, 3), color)

    monkeypatch.setattr(port.SceneBuilder, "add_welded_mesh", unwelded)
    r = shape_run()
    assert not r["correct"], r["checks"]


def ctx(host, traced=True, unit="step"):
    tr = devtrace.DeviceTrace.from_names(["k"], [0], [10], (0, 100)) if traced else None
    return run.Context(unit, 4, 3.0, 12.5, 2**30, host, {}, tr, devtrace.Spans(), "NVIDIA H100 80GB HBM3")


def test_shape_readers():
    host = {"forward_s": [0.2, 0.4], "backward_s": [0.5, 0.7], "steps": 4, "pixels": 100,
            "counters": {"grad.geom.rows": 4000, "kd.rebuilds": 2}}
    c = ctx(host)
    assert c.read("forward_ms.shape") == pytest.approx(300.0)
    assert c.read("backward_ms.shape") == pytest.approx(600.0)
    assert c.read("geom_rows_per_px.shape") == pytest.approx(10.0)
    assert c.read("kd_rebuilds.shape") == pytest.approx(50.0)
    assert ctx({**host, "counters": {"grad.geom.rows": 4000}}).read("kd_rebuilds.shape") == 0.0
    # untraced, or a program without the counters (the parent): nothing to report, no raise
    for name in ("forward_ms.shape", "backward_ms.shape"):
        assert ctx(host, traced=False).read(name) is None and ctx({}).read(name) is None
    for name in ("geom_rows_per_px.shape", "kd_rebuilds.shape"):
        assert ctx({"steps": 4, "pixels": 100, "counters": {"kd.lanes.any": 5}}).read(name) is None
        assert ctx({}).read(name) is None


def test_shape_modules_load_no_jax_and_the_reference_no_program():
    from gpubench.tests.test_import_guard import loaded_top_names

    jax = {"jax", "jaxlib", "flax", "dod_raytracer_tpu"}
    assert not loaded_top_names(("gpubench.traffic.shape_fit",)) & jax
    assert not loaded_top_names(("gpubench.reference.shape_fit",)) & (jax | {"dod_raytracer_tpu_torch"})
