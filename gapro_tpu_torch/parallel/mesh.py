"""Process groups and the data-parallel helpers (``gapro_tpu/parallel/mesh.py``)
on ``torch.distributed``.

The JAX package lays its devices out as a one-axis mesh and lets XLA sum
over it. The port runs one process a rank, each with its own device, and
sums with the process group's collectives:

* ``initialize_multihost`` joins the group that ``torchrun`` describes in
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, and does
  nothing without them, as the JAX one does without a coordinator;
* ``data_parallel_mesh`` creates (or takes) the group and gives each rank
  its device, ``cuda:{rank % device_count}``. The backend follows the
  devices: ``nccl`` where each rank has a card of its own, ``gloo`` where
  ranks share a card (NCCL refuses two ranks on one device) or run on the
  CPU;
* ``replicate`` broadcasts a module's parameters and buffers from rank 0;
  ``shard_batch`` takes a rank's own item of a per-rank list;
  ``process_allgather`` gathers a host tree from every rank;
* ``spawn_ranks`` starts the ranks of one host as processes and collects
  what each returns.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("parallel")


@dataclass
class DataParallelGroup:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (through the backend at every
        world size, one rank included); returns ``t``."""
        dist.all_reduce(t)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def initialize_multihost(device: str = "cuda") -> Optional[DataParallelGroup]:
    """Join the group ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); None, and nothing
    done, where they are absent."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return data_parallel_mesh(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                              init_method="env://", device=device)


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """A rank's device: ``cuda:{rank % device_count}``, or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world_size: int, device: str = "cuda") -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo``."""
    if torch.device(device).type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def data_parallel_mesh(world_size: int = 1, rank: int = 0, init_method: Optional[str] = None,
                       device: str = "cuda", timeout_s: float = 1800.0) -> DataParallelGroup:
    """This rank's ``DataParallelGroup``: the default process group (created
    here through ``init_method``, e.g. ``tcp://localhost:<port>``, unless one
    exists), its backend chosen by ``choose_backend`` and this rank's
    device by ``rank_device``."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        backend = dist.get_backend()
        world_size, rank = dist.get_world_size(), dist.get_rank()
    else:
        backend = choose_backend(world_size, device)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
    group = DataParallelGroup(rank=rank, world_size=world_size, device=dev, backend=backend)
    if rank == 0:
        log.info("data-parallel group: %d ranks, backend %s, rank 0 on %s", world_size,
                 backend, dev)
    return group


def replicate(module: torch.nn.Module, group: DataParallelGroup) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            group.broadcast(t.data)
    return module


def shard_batch(items, group: DataParallelGroup):
    """This rank's item of a per-rank sequence (a list, or an array or
    tensor with a leading rank axis), moved to the rank's device where it
    is an array or a tensor."""
    item = items[group.rank]
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(item)
    return item.to(group.device) if isinstance(item, torch.Tensor) else item


def process_allgather(tree, group: Optional[DataParallelGroup] = None):
    """A tree of host values (dicts, lists and tuples of numbers or numpy
    arrays) from every rank, each leaf stacked along a new leading rank
    axis. Outside a process group, the one process's tree with that axis."""
    trees = [tree]
    if group is not None and group.world_size > 1:
        trees = [None] * group.world_size
        dist.all_gather_object(trees, tree)
    return _stack(trees)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, nprocs: int, *args, timeout_s: float = 3600.0) -> dict:
    """Run ``fn(rank, init_method, results, *args)`` in ``nprocs`` processes
    spawned on this host (``torch.multiprocessing``, ``spawn``), their group
    reached through ``init_method``, ``tcp://localhost:<a free port>``. Each
    rank puts ``(rank, value)`` on ``results``, with numpy and Python values,
    not tensors: a queue shares a tensor's memory with a process that may
    have exited by the time it is read. Returns the values by rank; raises
    with a rank's traceback where one failed, and kills the ranks where they
    outlive ``timeout_s``."""
    import torch.multiprocessing as tmp

    results = tmp.get_context("spawn").Queue()
    ctx = tmp.start_processes(fn, args=(f"tcp://localhost:{free_port()}", results, *args),
                              nprocs=nprocs, join=False, start_method="spawn")
    got, deadline = {}, time.monotonic() + timeout_s
    while len(got) < nprocs and time.monotonic() < deadline:  # drain before joining
        try:
            rank, value = results.get(timeout=1.0)
            got[rank] = value
        except queue.Empty:
            codes = [p.exitcode for p in ctx.processes]
            if any(c not in (None, 0) for c in codes) or all(c is not None for c in codes):
                break
    while not ctx.join(timeout=5):  # raises with the traceback of a rank that failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {nprocs} ranks outlived {timeout_s} s")
    if len(got) < nprocs:
        raise RuntimeError(f"only ranks {sorted(got)} of {nprocs} reported")
    return got
