"""Device time of a benchmark cell by the port's own spans.

    python3 scripts/torch_span_profile.py --workload teapot-frame --seed 7 --seconds 50 [--tracer 0|1]

Runs one cell through ``gpubench/run.py``'s own ``run_cell`` with
``--trace 1``, with the port's tracer (``utils/profiling.py``) turned on
just before the traffic's ``begin`` and turned off, and its records taken,
at its ``end``; ``--tracer 0`` leaves it off.  Each device operation of the
window is attributed to the innermost program span open on the host when
it was launched: the profiler's CUDA runtime record that carries the
operation's correlation id gives the launch time, and the innermost span
is the latest-started span open then.  The program's spans are added to
the harness's before ``run_cell`` reads the trace, so each idle gap of its
``breakdown`` is named by the innermost span, harness or program, open at
its start.

Prints one JSON line: device ms and launches a unit (frame or step) by
innermost span and by bounce, the per-layer numbers the spans give
(``sort_ms.frame``, ``families_ms.frame``, ``shading_ms.frame``,
``kd_lanes_per_px.frame`` beside the reference's floor, ``forward_ms.fit``,
``recompute_ms.fit``), the share of operations matched to a launch and to
a span, the share of device ms the named groups cover, the harness's own
per-layer metrics of the same window, idle ms a unit by the span that
names each gap, ``breakdown`` and whether the window's output was correct.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SORT = ("render.sort", "shade.sort")
FAMILIES = ("hit.families", "hit.attrs", "shadow.families")
SHADING = ("shade.terms", "shade.rays", "render.blend")
KD = ("kd.closest", "kd.any")
COVER = SORT + FAMILIES + SHADING + KD + ("render.to_host",)


def innermost(start_ns, end_ns, t_ns) -> np.ndarray:
    """For each time in ``t_ns``, the index of the latest-started span with
    start <= t < end (the later index among equal starts), or -1."""
    start_ns, end_ns, t_ns = (np.asarray(x, np.int64) for x in (start_ns, end_ns, t_ns))
    out = np.full(len(t_ns), -1, np.int64)
    by_start = np.lexsort((np.arange(len(start_ns)), start_ns))
    heap, j = [], 0
    for i in np.argsort(t_ns, kind="stable"):
        t = t_ns[i]
        while j < len(by_start) and start_ns[by_start[j]] <= t:
            k = int(by_start[j])
            heapq.heappush(heap, (-int(start_ns[k]), -k))
            j += 1
        while heap and end_ns[-heap[0][1]] <= t:
            heapq.heappop(heap)  # closed for good: later times are no earlier
        if heap:
            out[i] = -heap[0][1]
    return out


def lineage(spans) -> dict:
    """Per span: its bounce ``k`` (from the nearest ``render.bounce`` at or
    above it, -1 for none) and whether ``train.forward`` or
    ``train.backward`` is at or above it.  A parent precedes its children."""
    k = np.full(len(spans), -1, np.int64)
    fwd = np.zeros(len(spans), bool)
    bwd = np.zeros(len(spans), bool)
    for i, s in enumerate(spans):
        p = s.parent
        k[i] = s.attrs.get("k", -1) if s.name == "render.bounce" else (k[p] if p >= 0 else -1)
        fwd[i] = s.name == "train.forward" or (p >= 0 and fwd[p])
        bwd[i] = s.name == "train.backward" or (p >= 0 and bwd[p])
    return {"k": k, "fwd": fwd, "bwd": bwd}


def launch_times(events, window) -> tuple:
    """-> (the launch time of each device operation that ``devtrace.read``
    keeps from ``events``, those that overlap ``window``, in its order;
    the number of runtime records).  The launch time is the start of the
    CUDA runtime record that shares the operation's correlation id, -1
    where none does."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = window
    launch_at, corr = {}, []
    for e in events:
        if e.device_type() != cuda:
            if e.name().startswith("cu"):
                launch_at[e.correlation_id()] = e.start_ns()
        elif min(e.start_ns() + e.duration_ns(), w1) > max(e.start_ns(), w0):
            corr.append(e.correlation_id())
    return np.array([launch_at.get(c, -1) for c in corr], np.int64), len(launch_at)


def attribute(spans, ops: dict, units: int, kernel) -> dict:
    """Tables of the window's operations by their innermost program span:
    ``kernel`` masks the operations that are kernels (not copies or
    fills); times are device ms a unit, launches are kernels a unit."""
    launched = ops["launch_ns"] >= 0
    owner = np.full(len(ops["names"]), -1, np.int64)
    owner[launched] = innermost([s.start_ns for s in spans], [s.end_ns if s.end_ns >= 0 else 2**62 for s in spans],
                                ops["launch_ns"][launched])
    ms = (ops["end_ns"] - ops["start_ns"]) / 1e6 / units
    names = np.array([s.name for s in spans] + ["none"])
    span_name = names[owner]  # -1 picks "none"
    lin = lineage(spans)
    k = np.append(lin["k"], -1)[owner]
    fwd, bwd = np.append(lin["fwd"], False)[owner], np.append(lin["bwd"], False)[owner]

    def table(keys, mask=None):
        m = np.ones(len(ms), bool) if mask is None else mask
        out = {}
        for key in np.unique(keys[m]):
            sel = m & (keys == key)
            out[str(key)] = {"ms": float(ms[sel].sum()), "launches": float((sel & kernel).sum()) / units}
        return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))

    total = float(ms.sum())
    group = lambda g: float(ms[np.isin(span_name, g)].sum())
    phase = np.where(bwd, "backward.", np.where(fwd, "forward.", ""))
    bounce = np.char.add(phase, k.astype(str))
    return {
        "ops": len(ms), "kernels": int(kernel.sum()), "launch_records": ops["launch_records"],
        "matched_to_launch_pct": 100.0 * float(launched.mean()) if len(ms) else 0.0,
        "matched_to_span_pct": 100.0 * float((owner >= 0).mean()) if len(ms) else 0.0,
        "kernels_matched_to_span_pct": 100.0 * float((owner >= 0)[kernel].mean()) if kernel.any() else 0.0,
        "device_ms": total,
        "by_span": table(span_name),
        "by_bounce": table(bounce, k >= 0),
        "groups_ms": {"sort": group(SORT), "families": group(FAMILIES), "shading": group(SHADING), "kd": group(KD),
                      "to_host": group(("render.to_host",))},
        "covered_pct": 100.0 * group(COVER) / total if total else 0.0,
        "forward_ms": float(ms[fwd].sum()),
        "recompute_ms": float(ms[bwd & (k >= 0)].sum()),
        "owner": owner,
    }


def idle_by_span(items, gaps, units: int) -> dict:
    """Idle ms a unit by the innermost span, harness or program, open at
    each gap's start; ``items`` are (name, start_ns, end_ns)."""
    names = [n for n, _, _ in items] + ["none"]
    at = innermost([a for _, a, _ in items], [b for _, _, b in items], [t for t, _ in gaps])
    idle: dict = {}
    for i, (_, s) in zip(at, gaps):
        idle[names[i]] = idle.get(names[i], 0.0) + 1e3 * s / units
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def tracing(tracer: bool, got: dict):
    """While open, ``gpubench.run.run_cell`` runs with the port's tracer on
    from just before the traffic's ``begin`` (if ``tracer``) to its
    ``end``, where the records go to ``got["rec"]`` and their spans into
    the harness's spans; the traffic object goes to ``got["traffic"]``.
    A traced run also leaves its ``DeviceTrace`` in ``got["tr"]`` and the
    launch times of its operations in ``got["launch_ns"]``."""
    from dod_raytracer_tpu_torch.utils import profiling
    from gpubench import devtrace
    from gpubench import run as harness

    load, read = harness.load, devtrace.read

    def load_traced(path):
        mod = load(path)
        if not hasattr(mod, "Traffic"):
            return mod

        class Traffic(mod.Traffic):
            def begin(self, traced):
                got["traffic"] = self
                if tracer:
                    profiling.enable()
                super().begin(traced)

            def end(self):
                profiling.disable()
                got["rec"] = profiling.take()
                for s in got["rec"]["spans"]:
                    self.spans.add(s.name, s.start_ns, s.end_ns)
                super().end()

        mod.Traffic = Traffic
        return mod

    def read_launches(prof, window, timings):
        got["tr"] = tr = read(prof, window, timings)
        got["launch_ns"], got["launch_records"] = launch_times(prof.profiler.kineto_results.events(), window)
        if len(got["launch_ns"]) != len(tr.op):
            raise RuntimeError("the launch times do not line up with the trace's operations")
        return tr

    harness.load, devtrace.read = load_traced, read_launches
    try:
        yield
    finally:
        harness.load, devtrace.read = load, read
        profiling.disable()


def run(workload: str, seed: int, seconds: float, tracer: bool) -> dict:
    """One traced run of ``workload`` on the card, by ``run_cell``."""
    from gpubench import devtrace
    from gpubench import run as harness

    got: dict = {}
    with tracing(tracer, got):
        result = harness.run_cell(workload, seed, seconds, True)
    tr, rec, traffic = got["tr"], got["rec"], got["traffic"]
    units = result["attempted"]
    ops = {"launch_records": got["launch_records"], "names": [tr.table[i] for i in tr.op], "start_ns": tr.start_ns,
           "end_ns": tr.end_ns, "launch_ns": got["launch_ns"]}
    out = {"workload": workload, "seed": seed, "tracer": tracer, "unit": traffic.unit, "units": units,
           "window_s": result["device"]["window_s"], "per_unit_s": result["device"]["window_s"] / units,
           "busy_s": result["device"]["busy_s"], "correct": result["correct"],
           "checks": {k: c["value"] for k, c in result["checks"].items()},
           "harness_metrics": {k: m["value"] for k, m in result["metrics"].items()},
           "spans": len(rec["spans"]), "counters": rec["counters"]}
    attr = attribute(rec["spans"], ops, units, tr.kernels())
    owner = attr.pop("owner")
    out["attribution"] = attr
    walk = harness.load(os.path.join(harness.HERE, "metrics", "kd_walk_ms.frame.py")).walk_mask(tr)
    dur = (ops["end_ns"] - ops["start_ns"]) / 1e6 / units
    span_names = np.array([s.name for s in rec["spans"]] + ["none"])[owner]
    out["kernels_by_span"] = {name: _top(ops["names"], dur, span_names == name, 8)
                              for name in list(attr["by_span"])[:6]}
    in_kd = np.isin(span_names, KD)
    out["kd_span_vs_walk_kernels_ms"] = {"kd_spans": float(dur[in_kd].sum()), "walk_kernels": float(dur[walk].sum()),
                                         "in_kd_not_walk": _top(ops["names"], dur, in_kd & ~walk),
                                         "walk_not_in_kd": _top(ops["names"], dur, walk & ~in_kd)}
    if traffic.unit == "frame":
        pixels = traffic.work["pixels"] * units
        lanes = rec["counters"].get("kd.lanes.closest", 0) + rec["counters"].get("kd.lanes.any", 0)
        g = attr["groups_ms"]
        out["metrics"] = {"sort_ms.frame": g["sort"], "families_ms.frame": g["families"],
                          "shading_ms.frame": g["shading"], "kd_lanes_per_px.frame": lanes / pixels,
                          "kd_lanes_floor_per_px": traffic.work["closest_per_px"] + traffic.work["shadow_per_px"]}
    else:
        out["metrics"] = {"forward_ms.fit": attr["forward_ms"], "recompute_ms.fit": attr["recompute_ms"]}
    out["idle_ms_by_span"] = idle_by_span(traffic.spans.items, devtrace.idle_gaps(tr), units)
    out["breakdown"] = result["breakdown"]
    out["card"] = result["diagnostics"].get("card", "")
    return out


def _top(names, dur, mask, top: int = 5) -> list:
    sums: dict = {}
    for i in np.nonzero(mask)[0]:
        sums[names[i]] = sums.get(names[i], 0.0) + float(dur[i])
    return sorted(([n[:160], v] for n, v in sums.items()), key=lambda kv: -kv[1])[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_span_profile: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.workload, args.seed, args.seconds, bool(args.tracer))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
