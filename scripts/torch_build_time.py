#!/usr/bin/env python3
"""Time the port's host scene build on one mesh, and the kd builder in it.

    python scripts/torch_build_time.py [--mesh dragon] [--config config.ini] [KEY=VALUE ...]

Loads the mesh, builds its SAH tree alone with the builder that
``accel.kdtree.build_kdtree`` uses (``host_build``: the native C++ builder
when ``g++`` can build it, else the numpy builder), then builds
``default_scene(seed=0)`` on the CPU with the config (``config.ini``
alone: MaxPrims=8, leaf_chunk_lanes=8, the shape the CLI builds for
``--mesh dragon``), and prints one JSON line: the load, tree and whole
build seconds (host clock), which builder built the tree, and the tree's
shape.  Nothing runs on a GPU; uploading the tensors is not timed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default="dragon")
    p.add_argument("--config", default="config.ini")
    p.add_argument("overrides", nargs="*", metavar="KEY=VALUE")
    args = p.parse_args(argv)

    from dod_raytracer_tpu_torch import Config, default_scene
    from dod_raytracer_tpu_torch.accel.kdtree import host_build

    overrides = dict(kv.partition("=")[::2] for kv in args.overrides)
    cfg = Config.load(args.config, **{k: type(getattr(Config(), k))(v) for k, v in overrides.items()})
    t = time.perf_counter()
    scene_spec = default_scene(seed=0, cfg=cfg, mesh=args.mesh)
    load_s = time.perf_counter() - t
    tv = scene_spec._tri_verts[0]
    t = time.perf_counter()
    _, builder = host_build(tv, cfg)
    tree_s = time.perf_counter() - t
    t = time.perf_counter()
    scene = scene_spec.build(cfg, device="cpu")
    build_s = time.perf_counter() - t
    kd = scene.kd
    print(json.dumps({"mesh": args.mesh, "triangles": scene.n_triangles, "MaxPrims": cfg.MaxPrims,
                      "leaf_chunk_lanes": cfg.leaf_chunk_lanes, "load_s": load_s, "builder": builder,
                      "tree_s": tree_s, "build_s": build_s,
                      "nodes": int(kd.node_flag.shape[0]), "leaves": int((kd.node_flag == 3).sum()),
                      "depth": kd.max_depth, "blocks": int(kd.block_orig.shape[0]),
                      "block_slots": int(kd.block_orig.shape[1]),
                      "treelets": None if kd.tre_tbl is None else int(kd.tre_tbl.shape[0]),
                      "cpus": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
