"""The harness and the reference load neither JAX nor the JAX package; the
reference loads nothing of the program either.  Each check runs in a fresh
process, so that other tests' imports cannot mask a load."""

import os
import subprocess
import sys

from gpubench import run

HARNESS = ("gpubench.run", "gpubench.control", "gpubench.devtrace", "gpubench.traffic.frames",
           "gpubench.traffic.fit", "gpubench.scenes.inputs")
REFERENCE = ("gpubench.reference.render", "gpubench.reference.fit", "gpubench.scenes.inputs")


def loaded_top_names(modules, extra=""):
    code = ("import sys, importlib, glob, os\n"
            f"sys.path.insert(0, {run.ROOT!r})\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_harness_loads_no_jax():
    metrics = ("from gpubench.run import load, HERE\n"
               "for f in glob.glob(os.path.join(HERE, 'metrics', '*.py')): load(f)")
    names = loaded_top_names(HARNESS, metrics)
    assert not names & {"jax", "jaxlib", "flax", "dod_raytracer_tpu"}


def test_a_run_loads_no_jax():
    run_cpu = ("from gpubench import run\n"
               "run.run_cell('teapot-frame', 5, 0.1, False, device='cpu',"
               " overrides=dict(Width=16, Height=8, recursion_depth=1))")
    names = loaded_top_names(("gpubench.run",), run_cpu)
    assert "dod_raytracer_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "dod_raytracer_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "dod_raytracer_tpu", "dod_raytracer_tpu_torch"}
