"""The port's tracer: named spans and host counters, off by default.

``enable()`` turns it on and ``disable()`` off.  While it is off,
``span(name, **attrs)`` and ``count(name, n)`` check one module-level
flag and do nothing else.  While it is on, each span opens a
``torch.profiler.record_function`` range (so a profiler trace shows it)
and keeps one ``Span`` record in memory: its name, the index of its
parent, its thread, its host start and end from ``time.time_ns()`` (the
clock of ``torch.profiler``'s events, so spans and device intervals share
one time base) and its small attributes (``tile``, bounce ``k``).  A
span's parent is the latest-started span still open when it opens, on any
thread: a bounce that autograd's device thread recomputes inside
``loss.backward()`` nests under the span open around that call.  Counters
are integer adds on the host: no device work, no host read.

``take()`` returns the spans and counters recorded since ``enable()`` or
the last ``take()``, and clears them.  Kernel launches are not counted
here: the ``ops`` modules' ``launches`` dicts are their one count.

``log_render_stats`` keeps the JAX package's rays-per-second record.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import torch

logger = logging.getLogger("dod_raytracer_tpu_torch")

_on = False
_spans: list = []
_open: list = []  # (index into _spans, Span) of the spans open now, in start order
_counts: dict = {}
_lock = threading.Lock()


@dataclasses.dataclass
class Span:
    name: str
    parent: int  # index of the parent span in the same take(), -1 for none
    thread: int
    start_ns: int
    end_ns: int  # -1 while open
    attrs: dict


class _Off:
    """The span of a tracer that is off: enters and exits, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        with _lock:
            self.rec = Span(self.name, _open[-1][0] if _open else -1, threading.get_ident(), time.time_ns(), -1,
                            self.attrs)
            _open.append((len(_spans), self.rec))
            _spans.append(self.rec)
        return None

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        with _lock:
            for i, (_, rec) in enumerate(_open):
                if rec is self.rec:
                    del _open[i]
                    break
        self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager: a span named ``name`` while the tracer is on.

    Spans are opened by one caller thread at a time: autograd's device
    thread opens its spans while the caller waits in ``loss.backward()``.
    Two threads that opened spans at once would each take the other's
    latest open span as a parent."""
    if not _on:
        return _OFF
    return _On(name, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host int) to the counter ``name`` while the tracer is on."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> dict:
    """-> {"spans": [Span], "counters": {name: int}} recorded since
    ``enable()`` or the last ``take()``; both are cleared.  A span still
    open has ``end_ns`` -1 until it closes, and no later span takes it as
    a parent."""
    with _lock:
        spans, counts = list(_spans), dict(_counts)
        _spans.clear()
        _open.clear()
        _counts.clear()
    return {"spans": spans, "counters": counts}


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
