"""Several processes on `torch.distributed`: the JAX package's
`parallel/multihost.py` (`jax.distributed` bootstrap and the host-0
gather) for the port.

One process per host (or per card) joins a process group; each owns the
positions of the (tile, spp) layout that `sharding.make_mesh` gives its
rank (rank-major, as `jax.devices()` orders the devices of several
processes).  The sharded renders and train steps merge across processes
with one all-reduce of their partial sums (and, in a train step, one of
the gradients), so every rank ends with the merged frame.

The backend is always an explicit choice: "nccl" when the process has a
CUDA card, "gloo" on the CPU, unless `init` is told otherwise.  Under
"gloo" a collective of CUDA tensors is staged through host memory here
(`all_reduce`): that is how two ranks share one card, which NCCL refuses.
Every collective runs under the group's time limit (`init(timeout_s=)`),
so a rank that never arrives fails the others instead of hanging them.

In one process every function is a no-op or a local copy: `init()`
without a coordinator returns False.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         backend: Optional[str] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns True if several processes are
    active.

    The arguments default from torchrun's environment: `MASTER_ADDR` and
    `MASTER_PORT` ("host:port"), `WORLD_SIZE` and `RANK`.  Without a
    coordinator, or with one process, nothing is initialised and the
    return is False.  `backend` None picks "nccl" where CUDA is available
    and "gloo" elsewhere; `timeout_s` bounds every collective."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes in (None, 1):
        return process_count() > 1
    if process_id is None:
        raise ValueError("a process group needs this process's rank "
                         "(process_id or RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return process_count() > 1


def shutdown() -> None:
    """Leave the process group (a no-op in one process)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the processes, as a new tensor on x's device
    (a copy of x in one process).  Under "gloo" a CUDA tensor goes through
    host memory; under "nccl" a CPU tensor goes through the current CUDA
    device."""
    if process_count() == 1:
        return x.clone()
    via = (torch.device("cpu") if dist.get_backend() == "gloo"
           else torch.device("cuda", torch.cuda.current_device()))
    staged = x.detach().to(via, copy=True).contiguous()
    dist.all_reduce(staged)
    return staged.to(x.device)


def all_gather_object(obj) -> list:
    """[obj of rank 0, obj of rank 1, ...] (`[obj]` in one process)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_to_host0(img) -> Optional[np.ndarray]:
    """The frame on the host of process 0 (the multi-host `glReadPixels`,
    `Graphics.cpp:759`): a numpy copy there, None on the other ranks.

    The sharded renders leave the merged frame on every rank (their merge
    is an all-reduce), so rank 0's copy is the whole image; the ranks meet
    at a barrier first, so none returns before rank 0 holds it.  In one
    process it is the host copy."""
    host = np.asarray(img.detach().cpu() if torch.is_tensor(img) else img)
    if process_count() == 1:
        return host
    sync()
    return host if is_primary() else None


def sync() -> None:
    """A barrier across the processes (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier()
