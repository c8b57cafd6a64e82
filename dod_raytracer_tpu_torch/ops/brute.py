"""The triangle-axis split of the brute-force kernels ``csrc/mt_closest.cu``
and ``csrc/plucker_closest.cu`` (one template, ``csrc/brute.cuh``): the
rule that cuts a launch into splits, the triangle range of each split, the
plain version of the exact (t, index) merge, and the launch code both
wrappers share.

A launch of n rays over T' triangles runs (ray tiles, splits) CTAs; each
CTA scans its split's triangles in index order and keeps its lowest index
at a tie.  The splits merge by the least 64-bit key (bits(t) << 32) | idx,
which is the least t and, at equal t, the lowest index: the one in-order
scan's answer, so the result does not depend on the split count.
"""

from __future__ import annotations

import functools

import torch

from . import _cuda

RAYS_PER_CTA = 256  # brute.cuh kCtaRays: 128 threads, 2 rays each
TILE = 128  # brute.cuh kTile: triangles a staged tile, the unit of a split
# the CTAs a launch aims for on each SM before it splits no more: on the
# H100 the 16,384-ray launch over 6,656 columns ran fastest at 52 splits
# (25 CTAs an SM) of 1 to 52 (PERF.md §6)
CTAS_PER_SM = 32
SMS = 132  # an H100 SXM's SMs, for the rule away from a card
MISS_KEY = 0x7F800000_00000000  # (bits(+inf) << 32) | 0: a ray no split hit
STATS_ROWS = ("warp_steps", "pairs")  # the stats build's rows, by stage reached


def splits(n: int, t_total: int, sms: int = SMS) -> int:
    """The triangle splits of one launch of ``n`` rays over ``t_total``
    triangles: as many as it takes for CTAS_PER_SM CTAs on each of ``sms``
    SMs, at least 1 and at most one a tile."""
    tiles = max(1, t_total // TILE)
    ray_ctas = max(1, -(-n // RAYS_PER_CTA))
    return max(1, min(tiles, -(-CTAS_PER_SM * sms // ray_ctas)))


def ranges(t_total: int, count: int) -> list:
    """The triangle range [start, stop) of each of ``count`` splits, as the
    kernel cuts the ``t_total // TILE`` tiles."""
    tiles = t_total // TILE
    return [(s * tiles // count * TILE, (s + 1) * tiles // count * TILE) for s in range(count)]


def merge_plain(parts, n: int, device=None):
    """The kernels' merge in torch: each split's (t, idx), idx already
    global, keyed (bits(t) << 32) | idx where it hit (t finite) and
    MISS_KEY where it did not; the least key of each ray unpacked -> (t
    (n,) f32, idx (n,) i32), (inf, 0) where no split hit."""
    keys = torch.full((n,), MISS_KEY, dtype=torch.int64, device=device)
    for t, idx in parts:
        k = (t.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)
        keys = torch.minimum(keys, torch.where(torch.isfinite(t), k, MISS_KEY))
    return (keys >> 32).to(torch.int32).view(torch.float32), (keys & 0xFFFFFFFF).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(name: str, packed, shape, o, d) -> None:
    """The inputs of a launch on CUDA tensors: ``packed`` of ``shape``
    (T' a multiple of the kernels' 512), (N, 3) o and d."""
    n = o.shape[0]
    dev = o.device
    _cuda.check_count(n)
    _cuda.check(name, packed, torch.float32, shape, dev)
    _cuda.check("o", o, torch.float32, (n, 3), dev)
    _cuda.check("d", d, torch.float32, (n, 3), dev)


def launch(fn, what: str, packed, o, d, count, stats):
    """One call of the split kernel ``fn`` on checked inputs -> (t, idx);
    ``count`` splits (None: the ``splits`` rule on this card), ``stats`` an
    optional zeroed (2, 4) int64 CUDA tensor the stats build adds its
    counts to (rows ``STATS_ROWS``, columns the module's ``EXITS``)."""
    n, t_total, dev = o.shape[0], packed.shape[-1], o.device
    if count is None:
        count = splits(n, t_total, _sms(dev.index))
    if not 1 <= count <= t_total // TILE:
        raise ValueError(f"{count} splits of {t_total} triangles: 1 to {t_total // TILE}")
    if stats is not None:
        _cuda.check("stats", stats, torch.int64, (len(STATS_ROWS), 4), dev)
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx
    keys = torch.full((n,), MISS_KEY, dtype=torch.int64, device=dev) if count > 1 else None
    ptr = lambda x: 0 if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), o.data_ptr(), d.data_ptr(), t_out.data_ptr(), idx.data_ptr(), ptr(keys),
                 ptr(stats), n, t_total, count, _cuda.stream_of(dev))
    _cuda.raise_on(err, what)
    return t_out, idx


def launch_per_ray(fn, what: str, packed, o, d):
    """One call of the per-ray kernel ``fn`` on checked inputs -> (t, idx)."""
    n, dev = o.shape[0], o.device
    t_out = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t_out, idx
    with torch.cuda.device(dev):
        err = fn(packed.data_ptr(), o.data_ptr(), d.data_ptr(), t_out.data_ptr(), idx.data_ptr(), n,
                 packed.shape[-1], _cuda.stream_of(dev))
    _cuda.raise_on(err, what)
    return t_out, idx
