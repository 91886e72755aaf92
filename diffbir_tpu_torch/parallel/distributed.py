"""Multi-process launch on ``torch.distributed``: one process per card.

Counterpart of ``diffbir_tpu/parallel/distributed.py``. The launch contract
is the JAX package's:

    DIFFBIR_COORDINATOR=host:port    address of process 0
    DIFFBIR_NUM_PROCESSES=N          total processes
    DIFFBIR_PROCESS_ID=i             this process's rank

``maybe_initialize_distributed`` turns it into ``init_process_group`` at
``tcp://<coordinator>`` with that world size and rank: nccl on the card,
gloo on the CPU. ``DIFFBIR_AUTO_DISTRIBUTED=1`` reads torchrun's
environment (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), the
counterpart of JAX's detection from the TPU runtime. Each process drives
the card ``LOCAL_RANK`` names (0 by default).

Where JAX builds a global device mesh and lets XLA insert the collectives,
the port runs them itself (``parallel/mesh.py``): parameters broadcast from
rank 0 at start, gradients all-reduced (or reduce-scattered under
``train.fsdp``, ``parallel/fsdp.py``) before the optimiser's update.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

ENV = ("DIFFBIR_COORDINATOR", "DIFFBIR_NUM_PROCESSES", "DIFFBIR_PROCESS_ID")
AUTO_ENV = "DIFFBIR_AUTO_DISTRIBUTED"


def local_device(device: Union[str, torch.device]) -> torch.device:
    """The device this process drives: for cuda the card ``LOCAL_RANK``
    names (0 by default), made current; else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to "
                           "train on the CPU)")
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(local)
    return local


def maybe_initialize_distributed(device: Union[str, torch.device] = "cuda",
                                 backend: Optional[str] = None) -> bool:
    """Start the process group from the launch environment; returns whether
    one was started (False without the environment, or when one is already
    up, which its starter owns). ``backend``: nccl on a cuda ``device``,
    gloo otherwise, by default; gloo on cuda runs several processes on one
    card (nccl refuses two ranks on one device), staging CUDA tensors
    through the host. An incomplete DIFFBIR_* environment raises ValueError
    naming what is missing."""
    if dist.is_initialized():
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    coord = os.environ.get(ENV[0])
    if coord:
        missing = [k for k in ENV[1:] if not os.environ.get(k)]
        if missing:
            raise ValueError(f"{ENV[0]}={coord} is set without {', '.join(missing)}: a "
                             f"multi-process launch sets all of {', '.join(ENV)}")
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(os.environ[ENV[1]]),
                                rank=int(os.environ[ENV[2]]))
        return True
    if os.environ.get(AUTO_ENV):
        dist.init_process_group(backend, init_method="env://")
        return True
    return False


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Process-0 guard for checkpoint writes, tensorboard and prints."""
    return process_index() == 0


def process_seed(seed: int, grid=None) -> int:
    """The data seed of this process's rows (accelerate's
    set_seed(device_specific=True)), from its data index in ``grid``
    (``mesh.make_mesh``; default: the process index, every process a data
    index). The processes of one tensor group share a data index, so they
    draw the same rows and the same t, noise and augmentation: each sums
    its partials of the same inputs."""
    index = process_index() if grid is None else grid.data_index
    return seed + index * 1_000_003


def sync_processes(tag: str = "barrier") -> None:
    """Barrier across the processes (a no-op in one process). ``tag`` names
    the barrier, as JAX's ``sync_global_devices`` does; torch's carries no
    name."""
    del tag
    if dist.is_initialized():
        dist.barrier()
