"""Tracing and profiling helpers.

Counterpart of ``dod_raytracer_tpu.utils.profiling``: named
``torch.profiler.record_function`` ranges around the pipeline phases
(scene build, render, PNG write), which show in a ``torch.profiler``
trace, plus a wall-time log per phase and a rays-per-second record.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator

import torch

logger = logging.getLogger("dod_raytracer_tpu_torch")

_phase_times: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate a host-side phase: a ``record_function`` range in
    ``torch.profiler`` traces, and its wall time added to
    ``phase_times()``."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _phase_times[name] = _phase_times.get(name, 0.0) + dt
    logger.debug("phase %s: %.3fs", name, dt)


def annotate(name: str):
    """Decorator form of ``phase``."""
    def wrap(fn):
        def inner(*a, **k):
            with phase(name):
                return fn(*a, **k)
        return inner
    return wrap


def phase_times() -> dict[str, float]:
    return dict(_phase_times)


def reset_phase_times() -> None:
    _phase_times.clear()


def log_render_stats(n_rays: int, seconds: float, n_casts: int | None = None) -> dict:
    """Structured rays/sec record, with the JAX package's keys."""
    stats = {
        "primary_rays": n_rays,
        "seconds": seconds,
        "primary_rays_per_sec": n_rays / seconds if seconds > 0 else float("inf"),
    }
    if n_casts is not None:
        stats["total_casts"] = n_casts
        stats["casts_per_sec"] = n_casts / seconds
    logger.info("render stats: %s", stats)
    return stats
