"""Each metric reader's arithmetic on a synthetic trace."""

import pytest

from gpubench import devtrace, run

WALK = "void kdwarp::warp_walk_kernel<kdwarp::PacketNodes, true, false>(kdwarp::Tables, float const*, int)"
TORCH = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(...)"
COPY = "Memcpy DtoH (Device -> Pinned)"


def trace():
    # ns: walk 0-10 and 5-20 (overlap), torch 30-40, copy 45-50, window 0-100
    names = [WALK, WALK, TORCH, COPY]
    return devtrace.DeviceTrace.from_names(names, [0, 5, 30, 45], [10, 20, 40, 50], (0, 100))


def ctx(unit="frame", units=2, tr=None, kind="NVIDIA H100 80GB HBM3", work=None, host=None):
    spans = devtrace.Spans()
    spans.add("frame", 0, 60)
    spans.add("render_image", 1, 35)
    return run.Context(unit, units, 3.0, 12.5, 3 * 2**30, host or {"scene_build_s": 1.5, "backward_s": [0.2, 0.3]},
                       work or {"pixels": 1920 * 1080, "closest_per_px": 10.0, "shadow_per_px": 40.5}, tr, spans, kind)


def test_union_busy_and_idle_gaps():
    tr = trace()
    assert devtrace.union(tr.start_ns, tr.end_ns) == [(0, 20), (30, 40), (45, 50)]
    assert devtrace.busy_s(tr) == pytest.approx(35e-9)
    gaps = devtrace.idle_gaps(tr)
    assert [(t, round(s * 1e9)) for t, s in gaps] == [(20, 10), (40, 5), (50, 50)]
    b = devtrace.breakdown(tr, ctx().spans)
    assert b["idle_gaps"][0] == ["frame", 50e-9] and b["idle_gaps"][1] == ["render_image", 10e-9]
    assert b["device_ops"][0] == [WALK, 25e-9]


def test_readers():
    c = ctx(tr=trace())
    assert c.read("device_idle_pct.frame") == pytest.approx(65.0)
    assert c.read("device_idle_pct.fit") is None
    assert c.read("launches_per_frame.frame") == 1.5  # 3 kernels, the copy not counted, 2 frames
    assert c.read("kd_walk_ms.frame") == pytest.approx(25e-6 / 2)
    assert c.read("nonwalk_ms.frame") == pytest.approx(10e-6 / 2)
    assert c.read("frame_s") == 1.5 and c.read("step_s") is None
    assert c.read("peak_mem_gib") == 3.0 and c.read("setup_s") == 12.5 and c.read("scene_build_s") == 1.5
    assert ctx(unit="step", tr=trace()).read("backward_ms.fit") == pytest.approx(250.0)
    assert ctx(unit="step").read("backward_ms.fit") is None  # untraced: not reported


def test_kernel_classification():
    walk = ctx().module("kd_walk_ms.frame")
    for name in (WALK, "void kdwarp::warp_walk_kernel<kdwarp::ForestNodes, false, true>(...)",
                 "block_loop_kernel(float const*)", "void brute::closest_kernel<true>(...)",
                 "descend_kernel(float const*)", "mt_closest_per_ray_kernel(...)"):
        assert walk.is_walk(name), name
    for name in (TORCH, "void at::native::elementwise_kernel<128, 2>(...)", COPY,
                 "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)"):
        assert not walk.is_walk(name), name


def test_roofline_count():
    roof = ctx().module("kd_walk_roofline")
    work = {"pixels": 1920 * 1080, "closest_per_px": 9.5, "shadow_per_px": 41.25}
    want = 1920 * 1080 * (9.5 * 36 + 41.25 * 29) / 3.35e12
    assert roof.least_s(work, 3.35e12) == pytest.approx(want)
    c = ctx(tr=trace(), work=work)
    assert c.read("kd_walk_roofline") == pytest.approx(100 * want / (25e-9 / 2))
    assert ctx(tr=trace(), kind="cpu").read("kd_walk_roofline") is None  # no peak: nothing to read
    assert ctx(tr=trace(), work={"pixels": 100}).read("kd_walk_roofline") is None  # no count: nothing to read


def test_reference_counts_the_queries_its_semantics_make():
    """A closed box: every ray lives through every bounce, so one closest
    query a ray a bounce; a shadow query for each light facing a hit."""
    import torch

    from gpubench.reference import render as ref
    from gpubench.tests.test_faults import SEED
    from gpubench.tests.test_inputs import scene_cfg
    from gpubench.scenes import inputs

    cfg = scene_cfg("teapot-ref")
    s = ref.RefScene(inputs.scene_arrays(cfg, SEED, inputs.load_mesh(cfg)), 1e-4, "cpu")
    pix = torch.arange(0, 32 * 16, 7)
    counts = {}
    ref.render_pixels(s, 32, 16, 3, pix, counts)
    assert counts["closest"] == 3 * len(pix)
    lights = s.light_p.shape[0]
    assert 0 < counts["shadow"] < 3 * len(pix) * lights


def test_no_trace_no_per_layer_reading():
    c = ctx()
    for name in ("launches_per_frame.frame", "nonwalk_ms.frame", "kd_walk_ms.frame", "kd_walk_roofline",
                 "device_idle_pct.frame", "device_idle_pct.fit"):
        assert c.read(name) is None, name
