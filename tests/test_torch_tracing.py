"""The port's tracer (``utils/profiling.py``) on the CPU: off by default and
without effect on a frame; the span tree of a small frame; the kd lane
counter; the spans of a ``remat_bounces`` step; the CLI's ``--profile``.
And ``scripts/torch_span_profile.py``'s attribution of device operations
to spans by launch time, and idle gaps named by program spans, on
synthetic traces."""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

import dod_raytracer_tpu_torch as T
from dod_raytracer_tpu_torch import cli as tcli
from dod_raytracer_tpu_torch import grad as tgrad
from dod_raytracer_tpu_torch import train as ttrain
from dod_raytracer_tpu_torch.ops import packet
from dod_raytracer_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNCE = ["render.sort", "hit.families", "hit.triangles", "hit.attrs", "render.blend", "shade.terms",
          "shade.rays", "shade.sort", "shadow.families", "shadow.triangles", "shade.sort", "shade.terms",
          "render.blend"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def small(**kw):
    """16x8 teapot frame in two tiles of 64 rays, 3 bounces, with the bounce
    and shadow sorts on, so that every span of a bounce opens."""
    cfg = T.Config(**{"Width": 16, "Height": 8, "recursion_depth": 3, "ray_tile": 64, "MaxPrims": 96,
                      "leaf_chunk_lanes": 48, "sort_bounces": True, "shadow_batch_lights": True,
                      "sort_shadow": True, **kw})
    return cfg, T.default_scene(seed=0, cfg=cfg, mesh="teapot").build(cfg, device="cpu")


@pytest.fixture(scope="module")
def frame():
    return small()


def traced(fn):
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.take()


def children(spans, parent):
    return [i for i, s in enumerate(spans) if s.parent == parent]


def test_off_records_nothing_and_on_leaves_the_frame_bit_identical(frame):
    cfg, scene = frame
    assert profiling.span("a") is profiling.span("b", k=1)  # one no-op object: no range, no record
    off = T.render_image(scene, cfg, device="cpu")
    assert profiling.take() == {"spans": [], "counters": {}}
    on, rec = traced(lambda: T.render_image(scene, cfg, device="cpu"))
    assert rec["spans"] and torch.equal(off, on)
    assert T.render_image(scene, cfg, device="cpu").equal(off) and not profiling.take()["spans"]


def test_span_tree_of_a_small_frame(frame):
    cfg, scene = frame
    _, rec = traced(lambda: T.quantize_u8(T.render_image(scene, cfg, device="cpu")))
    spans = rec["spans"]
    roots = children(spans, -1)
    assert [spans[i].name for i in roots] == ["render.frame", "render.to_host"]
    tiles = children(spans, roots[0])
    assert [(spans[i].name, spans[i].attrs) for i in tiles] == [("render.tile", {"tile": t}) for t in (0, 1)]
    for t in tiles:
        bounces = children(spans, t)
        assert [(spans[i].name, spans[i].attrs) for i in bounces] == [("render.bounce", {"k": k}) for k in range(3)]
        for b in bounces:
            kids = children(spans, b)
            assert [spans[i].name for i in kids] == BOUNCE
            walks = {spans[i].name: [spans[j].name for j in children(spans, i)] for i in kids}
            assert walks["hit.triangles"] == ["kd.closest"] and walks["shadow.triangles"] == ["kd.any"]
    starts = [s.start_ns for s in spans]
    assert starts == sorted(starts)  # one thread: records in the order they opened
    for s in spans:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_ident()
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_kd_lanes_count_the_lanes_handed_to_the_walk(frame, monkeypatch):
    """``kd.lanes.<mode>`` against the rows the walk receives, dead lanes
    included: N rays a bounce closest, L x N any-hit (batched shadows);
    ``families.lanes.any``, the same L x N shadow lanes a bounce, handed to
    the families' any-hit first; ``families.lanes.closest``, the N rays a
    bounce handed to the families' closest hit first."""
    cfg, scene = frame
    seen = {"closest": 0, "any": 0}
    walk = packet.packet_traverse

    def counting(kd, o, d, t_max, depth, any_hit):
        seen["any" if any_hit else "closest"] += o.shape[0]
        return walk(kd, o, d, t_max, depth, any_hit)

    monkeypatch.setattr(packet, "packet_traverse", counting)
    _, rec = traced(lambda: T.render_image(scene, cfg, device="cpu"))
    n, lights = 16 * 8, scene.lights.position.shape[0]
    assert seen == {"closest": 3 * n, "any": 3 * n * lights}
    assert rec["counters"] == {"kd.lanes.closest": seen["closest"], "kd.lanes.any": seen["any"],
                               "families.lanes.any": seen["any"], "families.lanes.closest": seen["closest"]}


def test_remat_step_recomputes_its_bounces_under_backward():
    """In a ``remat_bounces`` step every bounce opens twice: under
    ``train.forward``, and recomputed under ``train.backward`` from the
    saved permutation, winners and shadow bits (no kd walk there)."""
    cfg, scene = small(Width=8, Height=8, recursion_depth=2, remat_bounces=True)
    with torch.no_grad():
        target = tgrad.render_for_grad(scene, cfg) * 0.9
    names = ("lights.intensity",)
    opt = ttrain.make_optimizer(0.05)(tgrad.split_float_params(scene, names))
    update = ttrain.make_update_fn(cfg, names)
    _, rec = traced(lambda: update(scene, opt, target))
    spans = rec["spans"]
    roots = [spans[i].name for i in children(spans, -1)]
    assert roots == ["train.forward", "train.backward", "train.optim"]

    def under(i):
        while spans[i].parent >= 0:
            i = spans[i].parent
        return spans[i].name

    bounces = {(under(i), s.attrs["k"]) for i, s in enumerate(spans) if s.name == "render.bounce"}
    assert bounces == {(phase, k) for phase in ("train.forward", "train.backward") for k in (0, 1)}
    in_backward = {s.name for i, s in enumerate(spans) if under(i) == "train.backward"}
    assert not in_backward & {"kd.closest", "kd.any", "hit.triangles", "shadow.families"}
    assert "hit.attrs" in in_backward and "shade.terms" in in_backward


def test_a_span_on_another_thread_nests_under_the_open_one():
    """autograd's device thread recomputes a bounce while the caller waits
    in ``loss.backward()``: its span takes the caller's open span as parent."""
    def other():
        with profiling.span("render.bounce", k=4):
            pass

    def body():
        with profiling.span("train.backward"):
            t = threading.Thread(target=other)
            t.start()
            t.join()

    _, rec = traced(body)
    outer, inner = rec["spans"]
    assert (inner.name, inner.parent, inner.attrs) == ("render.bounce", 0, {"k": 4})
    assert inner.thread != outer.thread and outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_cli_profile_writes_the_spans(tmp_path):
    out = tmp_path / "out.png"
    rc = tcli.main(["--output", str(out), "--mesh", "none", "--width", "16", "--height", "8", "--depth", "2",
                    "--cpu", "--profile", str(tmp_path / "prof")])
    assert rc == 0 and not profiling._on
    rec = json.loads((tmp_path / "prof" / "spans.json").read_text())
    names = [s["name"] for s in rec["spans"] if s["parent"] == -1]
    assert names == ["scene_build", "render", "png_write"]
    assert sum(s["name"] == "render.bounce" for s in rec["spans"]) == 2
    assert '"render.bounce"' in (tmp_path / "prof" / "trace.json").read_text()


# ---- the attribution of scripts/torch_span_profile.py ----

def _script():
    spec = importlib.util.spec_from_file_location("torch_span_profile",
                                                  os.path.join(ROOT, "scripts", "torch_span_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def S(name, parent, start, end, **attrs):
    return profiling.Span(name, parent, 1, start, end, attrs)


def test_innermost_is_the_latest_started_open_span():
    sp = _script()
    # 0: frame [0, 100); 1: bounce [10, 50); 2: sort [12, 20); 3: another thread's span [15, 30)
    starts, ends = [0, 10, 12, 15], [100, 50, 20, 30]
    got = sp.innermost(starts, ends, [5, 12, 16, 25, 35, 60, 100, -3, 13])
    assert got.tolist() == [0, 2, 3, 3, 1, 0, -1, -1, 2]
    assert sp.innermost([0, 0], [10, 10], [0]).tolist() == [1]  # equal starts: the later record


def test_attribute_by_innermost_span_bounce_and_step_phase():
    sp = _script()
    spans = [S("train.forward", -1, 0, 100), S("render.bounce", 0, 10, 60, k=0), S("shade.sort", 1, 20, 30),
             S("kd.any", 1, 40, 50), S("train.backward", -1, 100, 200), S("render.bounce", 4, 110, 150, k=0),
             S("shade.terms", 5, 120, 140)]
    # operations: name, device start, end, launch (-1: no runtime record)
    ops = [("k1", 1000, 1010, 5), ("sort", 1010, 1030, 25), ("walk", 1030, 1070, 45), ("k2", 1070, 1080, 55),
           ("terms", 1080, 1100, 130), ("grad", 1100, 1130, 160), ("Memcpy DtoH", 1130, 1134, 170),
           ("lost", 1134, 1136, -1)]
    table = {"launch_records": 7, "names": [o[0] for o in ops], "start_ns": np.array([o[1] for o in ops]),
             "end_ns": np.array([o[2] for o in ops]), "launch_ns": np.array([o[3] for o in ops])}
    kernel = np.array([not o[0].startswith("Memcpy") for o in ops])
    a = sp.attribute(spans, table, 2, kernel)
    ms = lambda ns: ns / 1e6 / 2
    assert a["by_span"]["kd.any"] == {"ms": ms(40), "launches": 0.5}
    assert a["by_span"]["train.backward"] == {"ms": ms(34), "launches": 0.5}  # a kernel and a copy
    assert a["by_span"]["none"] == {"ms": ms(2), "launches": 0.5}
    assert a["by_bounce"].keys() == {"forward.0", "backward.0"}
    assert a["by_bounce"]["forward.0"] == {"ms": pytest.approx(ms(70)), "launches": 1.5}
    assert a["by_bounce"]["backward.0"] == {"ms": ms(20), "launches": 0.5}
    assert a["groups_ms"] == pytest.approx({"sort": ms(20), "families": 0.0, "shading": ms(20), "kd": ms(40),
                                            "to_host": 0.0})
    assert a["forward_ms"] == pytest.approx(ms(80)) and a["recompute_ms"] == pytest.approx(ms(20))
    assert a["matched_to_launch_pct"] == pytest.approx(700 / 8) and a["matched_to_span_pct"] == pytest.approx(700 / 8)
    assert a["covered_pct"] == pytest.approx(100 * 80 / 136)
    assert a["owner"].tolist() == [0, 2, 3, 1, 6, 4, 4, -1]


def test_idle_gaps_are_named_by_program_spans(monkeypatch):
    """Program spans added to the harness's name a gap wherever one is
    open at its start; elsewhere the harness span does."""
    monkeypatch.syspath_prepend(ROOT)
    from gpubench import devtrace

    tr = devtrace.DeviceTrace.from_names(["k", "k", "k"], [0, 30, 70], [10, 40, 80], (0, 100))
    spans = devtrace.Spans()
    spans.add("frame", 0, 100)
    spans.add("render_image", 1, 60)
    assert [n for n, _ in devtrace.breakdown(tr, spans)["idle_gaps"]] == ["render_image", "render_image", "frame"]
    for s in (S("render.frame", -1, 2, 60), S("shade.sort", 0, 35, 45), S("render.to_host", -1, 62, 90)):
        spans.add(s.name, s.start_ns, s.end_ns)
    gaps = sorted((round(s * 1e9), n) for n, s in devtrace.breakdown(tr, spans)["idle_gaps"])
    assert gaps == [(20, "render.frame"), (20, "render.to_host"), (30, "shade.sort")]
    idle = _script().idle_by_span(spans.items, devtrace.idle_gaps(tr), 2)
    assert idle == pytest.approx({"shade.sort": 15e-6, "render.frame": 10e-6, "render.to_host": 10e-6})


@pytest.mark.parametrize("tracer", [True, False])
def test_the_script_runs_the_harness_cell_with_the_tracer_on(monkeypatch, tracer):
    """``tracing`` around ``gpubench``'s own ``run_cell`` (here untraced, on
    the CPU, at 16x8): the tracer is on from the traffic's ``begin`` to its
    ``end``, its spans join the harness's, and the harness is left as it was."""
    monkeypatch.syspath_prepend(ROOT)
    from gpubench import devtrace
    from gpubench import run as harness

    sp, got = _script(), {}
    load, read = harness.load, devtrace.read
    with sp.tracing(tracer, got):
        result = harness.run_cell("teapot-frame", 2**31 + 5, 0.1, False, device="cpu",
                                  overrides=dict(Width=16, Height=8, recursion_depth=1))
    assert (harness.load, devtrace.read) == (load, read) and not profiling._on and "tr" not in got
    assert result["correct"] and result["attempted"] >= 1
    spans, harness_spans = got["rec"]["spans"], got["traffic"].spans.items
    assert {(s.name, s.start_ns, s.end_ns) for s in spans} <= set(harness_spans)
    frames = [s for s in spans if s.name == "render.frame"]
    assert len(frames) == result["attempted"] * tracer
    if tracer:
        renders = [(a, b) for n, a, b in harness_spans if n == "render_image"][-len(frames):]
        assert all(a <= s.start_ns <= s.end_ns <= b for s, (a, b) in zip(frames, renders))
        assert got["rec"]["counters"]["kd.lanes.closest"] == 16 * 8 * result["attempted"]
    else:
        assert got["rec"] == {"spans": [], "counters": {}}
