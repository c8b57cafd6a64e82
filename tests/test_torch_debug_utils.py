"""The port's debug and profiling utilities vs the JAX package's.

``compare_hits`` must give JAX's stats and print JAX's lines;
``checked`` (a dispatch mode in place of ``checkify``) raises at the
first op that makes a NaN or inf, intermediates included;
``assert_finite_tree`` names a bad leaf of a port ``Scene`` by its path;
the tracer's ``take()`` returns and clears what it recorded, and
``log_render_stats`` returns JAX's record.
"""

import time

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu.utils import debug as jdebug
from dod_raytracer_tpu.utils import profiling as jprof
from dod_raytracer_tpu_torch.utils import debug as tdebug
from dod_raytracer_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("max_report", [0, 3, 20])
def test_compare_hits_matches_jax(capsys, max_report):
    rng = np.random.default_rng(max_report)
    t_a = rng.uniform(0.5, 9.0, 200).astype(np.float32)
    t_b = t_a + rng.choice([0.0, 0.005, 0.5], 200).astype(np.float32)
    t_a[rng.random(200) < 0.1] = np.inf
    t_b[rng.random(200) < 0.1] = np.inf
    ref = jdebug.compare_hits(t_a, t_b, max_report=max_report, label_a="kd", label_b="brute")
    ref_out = capsys.readouterr().out
    got = tdebug.compare_hits(torch.from_numpy(t_a), torch.from_numpy(t_b), max_report=max_report,
                              label_a="kd", label_b="brute")
    assert got == ref and ref["hit_miss_mismatches"] > 0 and ref["t_mismatches"] > 0
    assert capsys.readouterr().out == ref_out


def test_checked_raises_on_nan_and_passes_finite():
    g = tdebug.checked(torch.log)
    x = torch.tensor([0.5, 1.0, 4.0])
    assert torch.equal(g(x), torch.log(x))
    with pytest.raises(FloatingPointError, match="log"):
        g(torch.tensor([-1.0]))
    # an intermediate, not only the output: the NaN is replaced before the end
    h = tdebug.checked(lambda v: torch.nan_to_num(torch.log(v)))
    with pytest.raises(FloatingPointError, match="log"):
        h(torch.tensor([-1.0, 2.0]))
    assert torch.equal(tdebug.checked(lambda v: torch.nan_to_num(torch.log(v)), check_nans=False)(
        torch.tensor([-1.0])), torch.tensor([0.0]))
    with pytest.raises(IndexError):  # check_oob: torch raises on its own
        tdebug.checked(lambda v: v[torch.tensor([5])])(x)


def test_assert_finite_tree_names_the_leaf():
    cfg = T.Config(Width=8, Height=4)
    scene = T.default_scene(seed=0, cfg=cfg, mesh=None).build(cfg, device="cpu")
    tdebug.assert_finite_tree(scene, "scene")
    tdebug.assert_finite_tree({"a": torch.ones(3), "b": torch.arange(3)})
    scene.spheres.center[3, 1] = float("nan")
    with pytest.raises(AssertionError, match=r"scene\.spheres/\.center contains 1 NaN / 0 inf"):
        tdebug.assert_finite_tree(scene, "scene")
    with pytest.raises(AssertionError, match=r"\['a'\] contains 0 NaN / 1 inf"):
        tdebug.assert_finite_tree({"a": torch.tensor([1.0, float("inf")])})


def test_take_returns_and_clears_spans_and_counters():
    """The tracer's ``take()``: the spans (nested, with their attributes)
    and counters since ``enable()``, and nothing the second time."""
    tprof.take()
    tprof.enable()
    try:
        with tprof.span("render.frame"):
            with tprof.span("render.tile", tile=3):
                time.sleep(0.001)
        tprof.count("kd.lanes.any", 5)
        tprof.count("kd.lanes.any", 7)
    finally:
        tprof.disable()
    got = tprof.take()
    frame, tile = got["spans"]
    assert (frame.name, frame.parent, tile.name, tile.parent, tile.attrs) == (
        "render.frame", -1, "render.tile", 0, {"tile": 3})
    assert frame.start_ns <= tile.start_ns < tile.end_ns <= frame.end_ns
    assert tile.end_ns - tile.start_ns >= 1_000_000
    assert got["counters"] == {"kd.lanes.any": 12}
    assert tprof.take() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("casts", [None, 12345])
def test_log_render_stats_matches_jax(casts):
    assert tprof.log_render_stats(2_073_600, 1.5, casts) == jprof.log_render_stats(2_073_600, 1.5, casts)
    assert tprof.log_render_stats(10, 0.0) == jprof.log_render_stats(10, 0.0)
