"""Wrapper of the CUDA kd-traversal kernel (``csrc/packet_traverse.cu``).

Counterpart of ``dod_raytracer_tpu.ops.pallas.packet_kernel.packet_traverse``.
The kernel is built at first use with plain ``nvcc`` for ``sm_90a`` into a
shared library with a C interface (``_build/``, listed in ``.gitignore``,
named by a hash of source and flags) and bound with ``ctypes``: pointers
and the stream go in as ``c_void_p``, the C function returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

``packet_traverse`` launches the kernel for CUDA tensors and takes the
plain walk (``traverse.traverse_plain``) only for CPU tensors.  Every
kernel launch adds one to ``launches[mode]``; nothing else does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from .traverse import _pack_nodes, traverse_plain

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "packet_traverse.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches by mode, counted where the kernel is launched
launches = {"closest": 0, "any_hit": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(force: bool = False) -> dict:
    """Compile the kernel library if it is not built yet.

    Returns {"path", "seconds", "log"}: ``log`` is nvcc's output
    (``-Xptxas -v``: registers, stack and spills per kernel), empty when
    an up-to-date library was already there.
    """
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libpacket_traverse_{tag}.so")
    if os.path.exists(path) and not force:
        return {"path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.dod_packet_traverse
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def packet_traverse(kd, o, d, t_max, stack_depth: int, any_hit: bool, stats=None):
    """kd traversal of N rays -> (t (N,) f32, prim (N,) i32, -1 where no
    hit, found (N,) bool).

    CUDA tensors need the kd tables ``block_orig``, ``block_tris``,
    ``block_g`` and ``block_aabb``; a missing one raises ``ValueError``.

    ``stats`` is for measurement only (the frame never passes it): an
    optional (N, 3) int32 CUDA tensor into which a separate build of the
    kernel writes each ray's interior-node steps, tested (AABB-passing)
    blocks and non-empty slots of those blocks whose edge signs it tested.
    """
    if o.device.type == "cpu":
        return traverse_plain(kd, o, d, t_max, stack_depth, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"packet_traverse runs on cuda or cpu tensors, got {o.device}")
    if not 1 <= stack_depth <= 64:
        raise ValueError(f"stack_depth {stack_depth} outside [1, 64]")
    dev = o.device
    n = o.shape[0]
    if n >= 2**31:
        raise ValueError(f"{n} rays: the kernel indexes rays with int32")
    missing = [k for k in ("block_orig", "block_tris", "block_g", "block_aabb") if getattr(kd, k) is None]
    if missing:
        raise ValueError(f"kd tables {missing} are missing: build them with accel.kdtree.refresh_kd_blocks")
    nodes = _pack_nodes(kd)
    bounds = torch.cat([kd.bounds_min, kd.bounds_max])
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    _check("t_max", t_max, torch.float32, (n,), dev)
    _check("nodes", nodes, torch.float32, (kd.node_flag.shape[0], 5), dev)
    _check("bounds", bounds, torch.float32, (6,), dev)
    _check("block_aabb", kd.block_aabb, torch.float32, (6, B), dev)
    _check("block_g", kd.block_g, torch.float32, (B, 16, 5 * spad), dev)
    _check("block_tris", kd.block_tris, torch.float32, (B, S, 9), dev)
    _check("block_orig", kd.block_orig, torch.int32, (B, S), dev)
    if stats is not None:
        _check("stats", stats, torch.int32, (n, 3), dev)

    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, prim, found.bool()
    fn = _library().dod_packet_traverse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nodes.data_ptr(), bounds.data_ptr(), kd.block_aabb.data_ptr(),
                 kd.block_g.data_ptr(), kd.block_tris.data_ptr(), kd.block_orig.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), prim.data_ptr(),
                 found.data_ptr(), 0 if stats is None else stats.data_ptr(),
                 n, B, S, spad, kd.block_lanes, stack_depth, int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"packet_traverse kernel launch failed: CUDA error {err}")
    launches["any_hit" if any_hit else "closest"] += 1
    return t_out, prim, found.bool()

