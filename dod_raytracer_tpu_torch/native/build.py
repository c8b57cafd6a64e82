"""Build the native host libraries (``kdtree_build.cpp``, ``objloader.cpp``).

Each source is compiled at first use with ``g++`` into its own shared
library, ``_build/lib<name>_<hash>.so`` (``_build/`` is listed in
``.gitignore``), named by a hash of the source and the flags, so an edit
to either gives a new library.  The compiler writes a temporary file that
is then renamed into place, so processes that build at once do not race.
``-ffp-contract=off`` keeps every product and sum its own rounding: the
builder's SAH costs are compared after truncation, and one contracted FMA
could move a split.  No ``-march``: the library stays portable between
hosts that share the checkout.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]
SOURCES = {"kdtree_build": "kdtree_build.cpp", "objloader": "objloader.cpp"}


def _gxx() -> str:
    gxx = os.environ.get("CXX") or shutil.which("g++")
    if not gxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH)")
    return gxx


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(_DIR, SOURCES[name]), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str, force: bool = False) -> dict:
    """Compile ``<name>.cpp`` if its library is not built yet.

    Returns {"name", "path", "seconds", "log"}; ``seconds`` is 0.0 when an
    up-to-date library was already there.  Raises RuntimeError with the
    compiler's output if the compiler is missing or fails.
    """
    path = library_path(name)
    if os.path.exists(path) and not force:
        return {"name": name, "path": path, "seconds": 0.0, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_gxx(), *GXX_FLAGS, "-o", tmp, os.path.join(_DIR, SOURCES[name])],
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on {SOURCES[name]} ({proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return {"name": name, "path": path, "seconds": seconds, "log": log}
