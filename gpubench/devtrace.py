"""The harness's spans and its reading of the device trace.

Spans are the harness's own, around its calls into the program: a name
and host-clock start and end in nanoseconds since the epoch, the time base
of ``torch.profiler``'s events.  A traced run (``--trace 1``) wraps the
window in ``torch.profiler`` with CUDA activity only: recording every host
op as well would slow the host's enqueue, which is part of what the
device's idle share measures.  ``read`` turns the profiler's device events
into a ``DeviceTrace``: the intervals of every device operation (kernels,
copies, fills) inside the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np


class Spans:
    """Named host-clock intervals, also shown as ``record_function``
    ranges in a profiler trace."""

    def __init__(self):
        self.items: list = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        t0 = time.time_ns()
        with torch.profiler.record_function(name):
            yield
        self.items.append((name, t0, time.time_ns()))

    def add(self, name: str, start_ns: int, end_ns: int) -> None:
        self.items.append((name, start_ns, end_ns))

    def open_at(self, t_ns: int) -> str:
        """The innermost span open at ``t_ns`` (the latest started), or "none"."""
        best = None
        for n, a, b in self.items:
            if a <= t_ns < b and (best is None or a > best[1]):
                best = (n, a)
        return best[0] if best else "none"


@dataclasses.dataclass
class DeviceTrace:
    """Device operations of a traced window, clipped to it: interval i is
    an operation named ``table[op[i]]`` from ``start_ns[i]`` to ``end_ns[i]``."""

    table: list  # distinct operation names
    op: np.ndarray  # int, index into table
    start_ns: np.ndarray  # int64
    end_ns: np.ndarray  # int64
    window: tuple  # (start_ns, end_ns) of the measured window

    @classmethod
    def from_names(cls, names, start_ns, end_ns, window) -> "DeviceTrace":
        table, op = np.unique(np.array(names, dtype=str), return_inverse=True)
        return cls(list(table), op.reshape(-1), np.asarray(start_ns, np.int64), np.asarray(end_ns, np.int64), window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def name_mask(self, keep) -> np.ndarray:
        """Mask of the intervals whose operation's name ``keep`` accepts."""
        return np.array([bool(keep(n)) for n in self.table], bool)[self.op]

    def kernels(self) -> np.ndarray:
        """Mask of the intervals that are kernels (not copies or fills)."""
        return self.name_mask(lambda n: not (n.startswith("Memcpy") or n.startswith("Memset")))

    def seconds_by_name(self, mask=None) -> dict:
        dur = (self.end_ns - self.start_ns) / 1e9
        w = dur if mask is None else np.where(mask, dur, 0.0)
        sums = np.bincount(self.op, weights=w, minlength=len(self.table))
        return {n: float(v) for n, v in zip(self.table, sums) if v > 0}


def union(start_ns: np.ndarray, end_ns: np.ndarray) -> list:
    """The union of intervals as a sorted list of disjoint (start, end)."""
    if len(start_ns) == 0:
        return []
    order = np.argsort(start_ns, kind="stable")
    s, e = start_ns[order], np.maximum.accumulate(end_ns[order])
    first = np.concatenate([[0], np.nonzero(s[1:] > e[:-1])[0] + 1])
    last = np.concatenate([first[1:] - 1, [len(s) - 1]])
    return list(zip(s[first].tolist(), e[last].tolist()))


def busy_s(tr: DeviceTrace) -> float:
    """Seconds of the window in which some device operation ran."""
    return sum(b - a for a, b in union(tr.start_ns, tr.end_ns)) / 1e9


def idle_gaps(tr: DeviceTrace) -> list:
    """(start_ns, seconds) of every stretch of the window in which no
    device operation ran, the window's edges included."""
    gaps, t = [], tr.window[0]
    for a, b in union(tr.start_ns, tr.end_ns):
        if a > t:
            gaps.append((t, (a - t) / 1e9))
        t = max(t, b)
    if tr.window[1] > t:
        gaps.append((t, (tr.window[1] - t) / 1e9))
    return gaps


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def read(prof, window: tuple, timings: dict) -> DeviceTrace:
    """Stop ``prof`` and keep its device operations inside ``window``;
    ``timings`` gets the seconds that stopping and reading took."""
    import torch

    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    ids: dict = {}
    op, starts, ends = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = window
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a = e.start_ns()
        b = min(a + e.duration_ns(), w1)
        a = max(a, w0)
        if b > a:
            op.append(ids.setdefault(e.name(), len(ids)))
            starts.append(a)
            ends.append(b)
    timings.update(trace_stop_s=t1 - t0, trace_read_s=time.perf_counter() - t1)
    if not op:
        raise RuntimeError("the profiler recorded no device operation inside the window")
    return DeviceTrace(list(ids), np.array(op, np.int64), np.array(starts, np.int64), np.array(ends, np.int64),
                       window)


def breakdown(tr: DeviceTrace, spans: Spans, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the harness span open on the host at its start."""
    ops = sorted(tr.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(tr), key=lambda g: -g[1])[:top]
    return {"device_ops": [[_short(n), s] for n, s in ops],
            "idle_gaps": [[spans.open_at(t), s] for t, s in gaps]}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def save(path: str, tr: DeviceTrace, spans: Spans) -> None:
    """The trace as a compressed ``.npz``: the operation names, each
    interval's name index, start and end in nanoseconds from the window's
    start, and the harness's spans."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w0 = tr.window[0]
    np.savez_compressed(path, names=np.array(tr.table, dtype=str), op=tr.op.astype(np.int32),
                        start_ns=tr.start_ns - w0, end_ns=tr.end_ns - w0, window_ns=np.int64(tr.window[1] - w0),
                        span_names=np.array([n for n, _, _ in spans.items], dtype=str),
                        span_ns=np.array([[a - w0, b - w0] for _, a, b in spans.items], np.int64).reshape(-1, 2))
