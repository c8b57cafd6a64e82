"""A run with its timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU at a tiny size (the look
for a card skipped) with one fault planted in the program: for the frame
cells, half of the rays left out and a frame altered where it is
produced; for the fit, a step that returns its state unchanged (from the
start, or once the set-up steps are done), Adam's bias correction going
wrong once the set-up steps are done, and a loss taken over half of the
pixels.  One chip, so there is no exchange between
chips to leave out."""

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as port
import dod_raytracer_tpu_torch.grad as port_grad
import dod_raytracer_tpu_torch.train as port_train
from gpubench import run

SEED = 2**31 + 4242
FRAME = dict(Width=32, Height=16, recursion_depth=3)
FIT = dict(Width=16, Height=16, recursion_depth=3)


def frame_run(cell="teapot-frame"):
    return run.run_cell(cell, SEED, 0.1, False, device="cpu", overrides=FRAME)


def fit_run(seconds=0.1):
    return run.run_cell("teapot-fit", SEED, seconds, False, device="cpu", overrides=FIT)


def broken_in_the_window(monkeypatch, fault):
    """``make_update_fn`` whose steps after the set-up steps go through ``fault(update, scene, opt, target)``."""
    real = port_train.make_update_fn

    def patched(cfg, params, loss_fn=None):
        update = real(cfg, params, loss_fn)
        calls = []

        def step(scene, opt, target):
            calls.append(1)
            return update(scene, opt, target) if len(calls) <= 3 else fault(update, scene, opt, target)
        return step

    monkeypatch.setattr(port_train, "make_update_fn", patched)


def test_sound_frames_are_correct():
    r = frame_run()
    assert r["correct"] and r["failed"] == 0, r["checks"]


def test_half_of_the_rays_left_out(monkeypatch):
    real = port.render_image

    def half(scene, cfg, device="cuda"):
        img = real(scene, cfg, device=device)
        img[img.shape[0] // 2:] = 0.0
        return img

    monkeypatch.setattr(port, "render_image", half)
    r = frame_run()
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]


def test_a_frame_altered_where_it_is_produced(monkeypatch):
    real = port.quantize_u8
    monkeypatch.setattr(port, "quantize_u8", lambda img: np.ascontiguousarray(real(img)[..., ::-1]))
    r = frame_run()
    assert not r["correct"], r["checks"]


def test_sound_fit_is_correct():
    r = fit_run()
    assert r["correct"], r["checks"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    real = port_train.make_update_fn

    def stuck(cfg, params, loss_fn=None):
        update = real(cfg, params, loss_fn)

        def step(scene, opt, target):
            loss, _, opt = update(scene, opt, target)
            return loss, scene, opt
        return step

    monkeypatch.setattr(port_train, "make_update_fn", stuck)
    r = fit_run()
    assert not r["correct"] and r["checks"]["change_gap"]["value"] == pytest.approx(1.0), r["checks"]


def test_a_state_left_unchanged_inside_the_window(monkeypatch):
    def stuck(update, scene, opt, target):
        loss, _, opt = update(scene, opt, target)
        return loss, scene, opt

    broken_in_the_window(monkeypatch, stuck)
    r = fit_run(0.5)
    assert not r["correct"], r["checks"]


def test_adam_bias_correction_wrong_inside_the_window(monkeypatch):
    def step_count_reset(update, scene, opt, target):
        for state in opt.state.values():
            state["step"].zero_()
        return update(scene, opt, target)

    broken_in_the_window(monkeypatch, step_count_reset)
    r = fit_run(0.5)
    assert not r["correct"], r["checks"]


def test_half_of_the_pixels_left_out_of_the_loss(monkeypatch):
    def half(scene, target, cfg, width=None, height=None):
        img = port_grad.render_for_grad(scene, cfg, width, height)
        n = img.shape[0] // 2
        return torch.mean((img[:n] - target[:n]) ** 2)

    monkeypatch.setattr(port_grad, "mse_loss", half)
    r = fit_run()
    assert not r["correct"], r["checks"]
