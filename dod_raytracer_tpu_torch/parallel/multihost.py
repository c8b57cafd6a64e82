"""Process-group bootstrap and device meshes over ``torch.distributed``.

Counterpart of ``dod_raytracer_tpu.parallel.multihost``.  The reference
has no distributed runtime (pthreads over shared memory); the JAX package
starts ``jax.distributed`` and lays a ``jax.sharding.Mesh`` over every
chip.  Here one process is one rank, ranks form a ``torch.distributed``
world, and a ``Mesh`` holds this rank's place in a (dp,) or (dp, mp) grid
of ranks with one process group per axis.  The render and train code
(``sharding.py``, ``leaf_shard.py``) reads only the mesh.

The backend rule, decided before the group is made: NCCL when each rank
of this host has a card of its own, gloo when ranks share a card (a world
larger than the card count, as on a one-card machine) or run on the CPU.
Gloo stages CUDA tensors through the host.  Every group gets a timeout,
so a rank that hangs ends the run.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("dod_raytracer_tpu_torch")

TIMEOUT_S = 600.0  # default seconds a collective may wait for the other ranks


@dataclasses.dataclass
class Mesh:
    """This rank's place in a grid of ranks (``jax.sharding.Mesh``'s role).

    ``shape`` maps each axis name to its size; ``coords`` this rank's index
    along it; ``groups`` the process group of the ranks that differ from
    this one along that axis only (a dp row's ranks share the triangles'
    shard, an mp column's the rays).  Global rank r sits at
    ``np.unravel_index(r, shape)``, JAX's row-major device order.
    """

    axis_names: tuple
    shape: dict
    coords: dict
    groups: dict
    device: torch.device


def local_world_size() -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the whole
    world (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size() if dist.is_initialized() else 1))


def backend_for(device, local_ranks: int) -> str:
    """The backend rule (module docstring): 'nccl' when ``device`` is a
    card and each of this host's ``local_ranks`` ranks has one of its own,
    else 'gloo'."""
    if torch.device(device).type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: card ``LOCAL_RANK mod card count`` (ranks share
    cards round-robin), or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda", timeout_s: float = TIMEOUT_S) -> str:
    """Join the default process group (idempotent) -> its backend name.

    ``init_method`` is a ``file://`` or ``tcp://`` rendezvous with
    ``world_size`` and ``rank``; without it, torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is read, and without that
    the process is a world of one.  ``device`` ('cuda' or 'cpu') picks the
    backend by ``backend_for`` and, on a card, makes ``rank_device`` the
    current device.
    """
    if dist.is_initialized():
        return dist.get_backend()
    kwargs: dict[str, Any] = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kwargs.update(init_method=init_method, world_size=world_size, rank=rank)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kwargs.update(init_method="env://")
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        kwargs.update(store=dist.HashStore(), world_size=1, rank=0)
        world_size, rank, local = 1, 0, 1
    backend = backend_for(device, local)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, **kwargs)
    logger.info("process group: backend %s, rank %d of %d (%d on this host)", backend, rank, world_size, local)
    return backend


def global_mesh(axes: Sequence[str] = ("dp",), shape: Optional[Sequence[int]] = None, device="cuda",
                timeout_s: float = TIMEOUT_S) -> Mesh:
    """A mesh over every rank of the world (``initialize`` first).

    Default: 1D 'dp' over the world.  Two axes without a shape put hosts
    on the first and this host's ranks on the second (JAX's rule: rays
    sharded across hosts, triangles leaf-sharded within one).  More axes
    need an explicit shape.  Every rank must call it with the same
    arguments: each axis's groups are made by all ranks in one order.
    """
    world = dist.get_world_size()
    if shape is None:
        if len(axes) == 1:
            shape = (world,)
        elif len(axes) == 2:
            local = local_world_size()
            shape = (world // local, local)
        else:
            raise ValueError("provide an explicit shape for >2 axes")
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} over axes {tuple(axes)} does not cover a world of {world}")
    grid = np.arange(world).reshape(shape)
    me = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(me, shape))))
    groups = {}
    timeout = datetime.timedelta(seconds=timeout_s)
    for k, axis in enumerate(axes):
        for ranks in np.moveaxis(grid, k, -1).reshape(-1, shape[k]):
            group = dist.new_group([int(r) for r in ranks], timeout=timeout)
            if me in ranks:
                groups[axis] = group
    return Mesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)), coords=coords, groups=groups,
                device=rank_device(device))


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank: int, fn, world_size: int, results, args) -> None:
    try:
        value = fn(rank, world_size, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, value))


def spawn(world_size: int, fn, *args, timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    (the ``spawn`` start method) -> each rank's return value, by rank.

    ``fn`` must be importable by name and return a picklable value (numpy,
    not CUDA tensors); it joins the world itself (``initialize``).  A rank
    that raises or exits fails the call and the other ranks are ended; so
    are all of them after ``timeout_s`` seconds (``TimeoutError``).
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = torch.multiprocessing.start_processes(_rank_main, args=(fn, world_size, results, args),
                                                  nprocs=world_size, join=False, start_method="spawn")
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            # drain before joining: a rank blocks in put() while the pipe is full
            while not results.empty():
                rank, value = results.get()
                out[rank] = value
            if procs.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: the world of {world_size} ranks ran past {timeout_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(timeout=30)
    while not results.empty():
        rank, value = results.get()
        out[rank] = value
    return [out[r] for r in range(world_size)]
