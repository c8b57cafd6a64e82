"""Readings of a cell's control: the plain reference, computed in a lower
precision, put in the program's place and judged as a run judges the program.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 [--dtype bfloat16]

Prints one JSON line per seed with the cell's compared numbers, and the
limits they are held to.  The benchmark's own runs never run this; its
readings set the upper end of each limit (PERF.md).  Runs on the card, at
the cell's own size, and on the CPU only for the tests.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from gpubench import run  # noqa: E402


def readings(workload: str, seeds, dtype, device="cuda", fault="") -> list:
    import torch

    doc = run.bench()
    cell = run.cell_of(doc, workload)
    with open(os.path.join(HERE, "workloads", f"{workload}.json")) as f:
        wl = json.load(f)
    entry = {c["name"]: c for c in doc["configs"]}[cell["config"]]
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        config = json.load(f)
    traffic = run.load(os.path.join(HERE, "traffic", f"{cell['traffic']}.py"))
    return [{"seed": s, **traffic.control(config, wl, s, device, getattr(torch, dtype), fault)} for s in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--fault", default="", choices=("", "half_batch"),
                    help="plant a fault in that reference instead (with --dtype float32)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(args.workload, seeds, args.dtype, fault=args.fault):
        print(json.dumps({"workload": args.workload, "dtype": args.dtype, "fault": args.fault, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
