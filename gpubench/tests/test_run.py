"""The command without a card, and one short run on the card."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import run

CMD = [sys.executable, os.path.join(run.HERE, "run.py"), "--workload", "teapot-frame", "--seed", str(2**31 + 7),
       "--seconds", "1", "--trace", "0"]


def test_without_a_card_no_result_and_nonzero_exit():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(CMD, capture_output=True, text=True, timeout=300, cwd=run.ROOT, env=env)
    assert p.returncode != 0
    assert "{" not in p.stdout and "needs 1 CUDA device" in p.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and gpubench/, the
    program is missing: no result, non-zero exit."""
    import shutil

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cmd = [sys.executable, str(tmp_path / "gpubench" / "run.py")] + CMD[3:]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert p.returncode != 0 and "{" not in p.stdout


def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(CMD, capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and set(r["metrics"]) >= {"frame_s", "setup_s"}
