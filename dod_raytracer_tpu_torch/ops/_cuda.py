"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use with plain ``nvcc`` for
``sm_90a`` into its own shared library with a C interface
(``_build/lib<name>_<hash>.so``; ``_build/`` is listed in ``.gitignore``).
The hash covers the source, the ``csrc/`` headers it includes (directly
or through another header) and the flags, so an edit to any of them gives
a new library.  The libraries are bound with ``ctypes``: pointers and the
stream go in as ``c_void_p``, each C function returns
``cudaGetLastError()`` and its wrapper raises if that is not 0.  Nothing here runs at import time: the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}


def _nvcc() -> str:
    candidates = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _inputs(name: str) -> list:
    """The source and the csrc/ headers it includes, directly or through
    another header, in a fixed order."""
    src = os.path.join(CSRC, f"{name}.cu")
    headers, todo = set(), [src]
    while todo:
        with open(todo.pop()) as f:
            for h in re.findall(r'#include\s+"([^"]+)"', f.read()):
                if h not in headers:
                    headers.add(h)
                    todo.append(os.path.join(CSRC, h))
    return [src] + sorted(os.path.join(CSRC, h) for h in headers)


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _inputs(name):
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, force: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` if its library is not built yet.

    Returns {"name", "path", "seconds", "log"}: ``log`` is nvcc's output
    (``-Xptxas -v``: registers, stack and spills per kernel), empty when an
    up-to-date library was already there.
    """
    path = library_path(name)
    if os.path.exists(path) and not force:
        return {"name": name, "path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _inputs(name)[0]],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return {"name": name, "path": path, "seconds": seconds, "log": log}


def build_all(names, force: bool = False) -> list:
    """Build several kernels at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(lambda n: build(n, force), names))


def library(name: str, symbol: str, argtypes: list):
    """The bound C function ``symbol`` of ``csrc/<name>.cu`` (built if needed)."""
    if (name, symbol) not in _libs:
        lib = ctypes.CDLL(build(name)["path"])
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name, symbol] = fn
    return _libs[name, symbol]


def check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_blocks(kd, tables, device) -> None:
    """The kd leaf tables a kernel reads, for CUDA tensors: each of
    ``tables`` present, and block_g, block_tris, block_orig of matching
    shapes on ``device``."""
    missing = [k for k in tables if getattr(kd, k) is None]
    if missing:
        raise ValueError(f"kd tables {missing} are missing: build them with accel.kdtree")
    B, S = kd.block_orig.shape
    spad = kd.block_g.shape[2] // 5
    check("block_g", kd.block_g, torch.float32, (B, 16, 5 * spad), device)
    check("block_tris", kd.block_tris, torch.float32, (B, S, 9), device)
    check("block_orig", kd.block_orig, torch.int32, (B, S), device)


def check_count(n: int) -> None:
    if n >= 2**31:
        raise ValueError(f"{n} rays: the kernels index rays with int32")


def check_marks(kd, stats, touched, n: int, words: int, device) -> None:
    """The optional measurement outputs: ``stats`` (n, words) and
    ``touched`` (B, 2 + S), which needs ``stats``."""
    if stats is not None:
        check("stats", stats, torch.int32, (n, words), device)
    if touched is not None:
        if stats is None:
            raise ValueError("touched is written only by the stats build: pass stats too")
        check("touched", touched, torch.int32, (kd.block_orig.shape[0], 2 + kd.block_orig.shape[1]), device)


def check_rays(kd, o, d, t_max, stack_depth: int, stats, touched, tables) -> None:
    """Checks shared by the traversal wrappers, for CUDA tensors: the rays,
    the stack depth, the kd leaf tables and the optional measurement
    outputs (``stats`` (N, 4), ``touched`` (B, 2 + S), which needs
    ``stats``)."""
    if not 1 <= stack_depth <= 64:
        raise ValueError(f"stack_depth {stack_depth} outside [1, 64]")
    n = o.shape[0]
    check_count(n)
    dev = o.device
    check_blocks(kd, tables, dev)
    check("o", o, torch.float32, (n, 3), dev)
    check("d", d, torch.float32, (n, 3), dev)
    check("t_max", t_max, torch.float32, (n,), dev)
    check("bounds_min", kd.bounds_min, torch.float32, (3,), dev)
    check("bounds_max", kd.bounds_max, torch.float32, (3,), dev)
    check_marks(kd, stats, touched, n, 4, dev)


def outputs(n: int, device):
    """Uninitialised (t, prim, found) outputs of an n-ray traversal."""
    return (torch.empty((n,), dtype=torch.float32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device))


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
