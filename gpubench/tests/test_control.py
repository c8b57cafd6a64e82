"""The control, at a size a test run can hold: the plain reference in
bfloat16 put in the program's place fails the cell's limits, and so does
the fit's reference with half of the pixels left out of its loss.  The
readings that set the limits were taken on the card at each cell's size
(``gpubench/control.py``, PERF.md)."""

import json
import os

import pytest
import torch

from gpubench import run
from gpubench.traffic import fit, frames

SEEDS = (11, 2**31 + 3)


def load(cell, **render):
    with open(os.path.join(run.HERE, "workloads", f"{cell}.json")) as f:
        wl = json.load(f)
    entry = {c["name"]: c for c in run.bench()["configs"]}[wl["config"]]
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        config = json.load(f)
    config["render"] = dict(config["render"], **render)
    return config, wl


def fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_frame_control_is_not_correct(seed):
    config, wl = load("teapot-frame", Width=32, Height=16, recursion_depth=3)
    got = frames.control(config, wl, seed, "cpu", torch.bfloat16)
    assert fails(got, wl["params"]["limits"]), got


@pytest.mark.parametrize("fault", ["", "half_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fit_controls_are_not_correct(seed, fault):
    config, wl = load("teapot-fit", recursion_depth=3)
    wl["params"].update(width=16, height=16)
    dtype = torch.float32 if fault else torch.bfloat16
    got = fit.control(config, wl, seed, "cpu", dtype, fault)
    assert fails(got, wl["params"]["limits"]), got


def test_float32_control_is_the_reference_itself():
    config, wl = load("teapot-fit", recursion_depth=3)
    wl["params"].update(width=16, height=16)
    got = fit.control(config, wl, 5, "cpu", torch.float32)
    assert all(v == 0.0 for v in got.values()), got
