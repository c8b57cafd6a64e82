"""Debug and numerical-guard utilities.

Counterpart of ``dod_raytracer_tpu.utils.debug``:

* ``compare_hits`` — the reference's ``compareHitRecords`` diff harness
  (main.cpp:246-271) for batches: hit/miss disagreements and t mismatches
  (eps=0.01 by default) between two hit sets, keyed by ray index.
* ``checked`` — run a function so that a NaN or inf, in any intermediate
  as in the output, raises instead of flowing on (JAX's ``checkify``).
* ``assert_finite_tree`` — every float tensor of a scene, dict or tensor
  is finite.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def compare_hits(t_a, t_b, eps: float = 0.01, max_report: int = 20, label_a="A", label_b="B"):
    """Compare two per-ray hit distances (+inf = miss).  Returns a dict of
    mismatch stats and prints up to ``max_report`` diagnostics
    (compareHitRecords semantics, main.cpp:246-271)."""
    t_a = t_a.detach().cpu().numpy() if isinstance(t_a, torch.Tensor) else np.asarray(t_a)
    t_b = t_b.detach().cpu().numpy() if isinstance(t_b, torch.Tensor) else np.asarray(t_b)
    hit_a = np.isfinite(t_a)
    hit_b = np.isfinite(t_b)
    miss_mismatch = np.nonzero(hit_a ^ hit_b)[0]
    both = hit_a & hit_b
    t_mismatch = np.nonzero(both & (np.abs(t_a - t_b) > eps))[0]
    for i in miss_mismatch[:max_report]:
        a, b = ("HIT", "MISS") if hit_a[i] else ("MISS", "HIT")
        print(f"({i:6d}) - {label_a} {a} - {label_b} {b}")
    for i in t_mismatch[:max_report]:
        print(f"({i:6d}) - T mismatch -- {label_a}: {t_a[i]:f}, {label_b}: {t_b[i]:f}")
    return {
        "rays": t_a.shape[0],
        "hit_miss_mismatches": int(miss_mismatch.size),
        "t_mismatches": int(t_mismatch.size),
    }


class _NonFiniteTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op whose floating-point
    output holds a NaN or an inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{func} produced {int(torch.isnan(t).sum())} NaN / {int(torch.isinf(t).sum())} inf values")
        return out


def checked(fn, *, check_nans: bool = True, check_oob: bool = True):
    """``fn`` wrapped so that numerical faults raise instead of giving
    garbage, in place of JAX's ``checkify``.

    ``check_nans``: every op ``fn`` runs, intermediates included, runs
    under a dispatch mode that raises ``FloatingPointError``, naming the
    op, at the first floating-point output holding a NaN or an inf.  (The
    renderer's own misses are t = +inf, so wrap code that should stay
    finite.)  ``check_oob`` adds nothing: it relies on torch itself, which
    raises ``IndexError`` on an out-of-bounds index on the CPU and fails a
    device assert on CUDA.
    """
    del check_oob  # torch checks every index already

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not check_nans:
            return fn(*args, **kwargs)
        with _NonFiniteTrap():
            return fn(*args, **kwargs)

    return wrapper


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Raise ``AssertionError`` naming the first float tensor of ``tree``
    (a scene, dataclass, dict or tensor) with a NaN or inf, by its path as
    ``checkpoint._flatten_with_paths`` spells it (``.spheres/.center``)."""
    from ..checkpoint import _flatten_with_paths

    for path, leaf in _flatten_with_paths(tree).items():
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(
                f"{name}{path} contains {int(torch.isnan(leaf).sum())} NaN / "
                f"{int(torch.isinf(leaf).sum())} inf values")
