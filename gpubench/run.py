"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is found by name: its entry in ``BENCHMARK.json``,
its parameters in ``gpubench/workloads/<cell>.json``, its configuration in
the entry's ``file``, its traffic module in ``gpubench/traffic/<traffic>.py``
and each metric's reader in ``gpubench/metrics/<metric>.py``.  The run makes
its inputs from the seed, sets up the program (``dod_raytracer_tpu_torch``)
and warms every shape it uses, then drives whole units of work (frames or
steps) until ``--seconds`` have passed; the window ends with the last
unit.  With ``--trace 1`` the window runs under ``torch.profiler`` and the
per-layer metrics are reported, else the end-to-end ones.  After the
window the program's state is freed and the traffic module compares what
the window produced with the plain reference (``gpubench/reference``);
the metrics are read after that comparison, which also counts the work
a roofline's floor needs.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; the compared numbers and their limits come last, under
``checks``).  Without a CUDA device, or with JAX loaded in the process
once the window has closed, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), at the moment of the call."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _process_age()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dod_raytracer_tpu")  # top-level module names, compared whole
PROGRAM = "dod_raytracer_tpu_torch"
SETUP_SPANS = ("imports", "cuda_init", "inputs", "scene_build", "target", "start_build", "optimizer", "warm",
               "setup_steps")


def load(path: str):
    """The module in ``path`` (a name may hold '.' or '-', so by file)."""
    name = "gpubench_" + os.path.basename(path)[:-3].replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(doc: dict, workload: str) -> dict:
    cells = {c["name"]: c for c in doc["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    return cells[workload]


def metrics_of(doc: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with a
    trace the per-layer ones; a metric with ``workloads`` only in those."""
    return [m for m in doc["per_layer" if trace else "end_to_end"] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric's reader reads: the window, the units completed in
    it, set-up and memory, the traffic's host readings and the device trace."""

    def __init__(self, unit, units, window_s, setup_s, window_peak_bytes, host, work, trace, spans, kind):
        self.unit, self.units, self.window_s, self.setup_s = unit, units, window_s, setup_s
        self.window_peak_bytes, self.host, self.work = window_peak_bytes, host, work
        self.trace, self.spans, self.kind = trace, spans, kind
        self.busy_s = None
        self._mods: dict = {}
        if trace is not None:
            from gpubench import devtrace

            self.busy_s = devtrace.busy_s(trace)

    def module(self, name: str):
        if name not in self._mods:
            self._mods[name] = load(os.path.join(HERE, "metrics", f"{name}.py"))
        return self._mods[name]

    def read(self, name: str):
        return self.module(name).read(self)

    def peak(self, key: str):
        with open(os.path.join(HERE, "peaks.json")) as f:
            devices = json.load(f)["devices"]
        for prefix, peaks in devices.items():
            if self.kind.startswith(prefix):
                return peaks[key]
        return None


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict = None, out_dir: str = None) -> dict:
    """One run of ``workload``; -> the result object.  ``device`` and
    ``overrides`` (program config keys) exist for the CPU tests."""
    import torch

    from gpubench import devtrace

    doc = bench()
    cell = cell_of(doc, workload)
    with open(os.path.join(HERE, "workloads", f"{workload}.json")) as f:
        wl = json.load(f)
    if (wl["config"], wl["traffic"]) != (cell["config"], cell["traffic"]):
        raise RuntimeError(f"{workload}: workload file and BENCHMARK.json disagree on config or traffic")
    cfg_entry = {c["name"]: c for c in doc["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    mix = load(os.path.join(HERE, "traffic", f"{cell['traffic']}.py"))
    port = __import__(PROGRAM)
    cuda = torch.device(device).type == "cuda"

    spans = devtrace.Spans()
    spans.add("imports", time.time_ns() - int(1e9 * (AGE0 + time.perf_counter() - T0)), time.time_ns())
    if cuda:
        with spans("cuda_init"):
            torch.zeros(1, device=device)
    traffic = mix.Traffic(port, config, wl, seed, device, spans, overrides)
    traffic.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    prof = devtrace.start_profiler() if trace else None
    traffic.begin(trace)
    setup_s = AGE0 + (time.perf_counter() - T0)

    units = 0
    w0, t0 = time.time_ns(), time.perf_counter()
    while True:
        traffic.step()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_s, w1 = time.perf_counter() - t0, time.time_ns()
    traffic.end()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    timings: dict = {}
    tr = devtrace.read(prof, (w0, w1), timings) if trace else None
    del prof
    diagnostics = {**traffic.diagnostics(), **timings}
    diagnostics["setup_spans_s"] = {n: (b - a) / 1e9 for n, a, b in spans.items if b <= w0 and n in SETUP_SPANS}

    traffic.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = traffic.check()
    diagnostics["reference_s"] = time.perf_counter() - t_ref

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = Context(traffic.unit, units, window_s, setup_s, window_peak, traffic.host, traffic.work, tr, spans, kind)
    metrics = {}
    for m in metrics_of(doc, workload, trace):
        v = ctx.read(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0}
    result = {"attempted": units, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = ctx.busy_s, tr.window_s
        result["breakdown"] = devtrace.breakdown(tr, spans)
        if out_dir:
            t_save = time.perf_counter()
            devtrace.save(os.path.join(out_dir, f"{workload}-{seed}.trace.npz"), tr, spans)
            diagnostics["trace_save_s"] = time.perf_counter() - t_save
    del tr, ctx
    if cuda:
        diagnostics["card"] = card_line()
    diagnostics["torch"] = torch.__version__
    result = {"correct": all(v <= lim for v, lim in checks.values()) and failed == 0, **result, "failed": failed,
              "diagnostics": diagnostics,
              "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "gpubench_out"),
                    help="directory for a traced run's trace file (inside the checkout by default)")
    args = ap.parse_args(argv)

    import torch

    chips = cell_of(bench(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}. No result.", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), out_dir=args.out)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the process loaded {bad} (JAX or the JAX package); no result.", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
