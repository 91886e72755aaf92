"""Sharded optimiser state over the processes (``train.fsdp: true``).

Counterpart of ``diffbir_tpu/parallel/fsdp.py``: ``fsdp_dim`` is
``fsdp_spec``'s rule (shard a leaf along its largest dimension that divides
by the number of processes, the first such on ties; replicate a leaf where
none does, and every leaf of a single process). Here the rule places the
optimiser's fp32 masters and both AdamW moments: each process keeps and
updates its own shard (``train/optim.py``), the gradients are
reduce-scattered to it and the updated weights, rounded to the module's
dtype, all-gathered back.

The module's weights stay whole on every process. That is ZeRO-2 (sharded
optimiser state and gradient reduction), where JAX's GSPMD placement also
shards the weights between uses (ZeRO-3); the arithmetic, and so the
numbers, are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .distributed import process_index, world_size


def fsdp_dim(shape: Sequence[int], n_data: int) -> Optional[int]:
    """The dimension a leaf of ``shape`` is sharded along over ``n_data``
    processes, or None to replicate it (``fsdp_spec`` without tensor
    parallelism)."""
    if len(shape) == 0 or n_data <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n_data == 0:
            return i
    return None


def shard(full: torch.Tensor, dim: int) -> torch.Tensor:
    """This process's shard of ``full`` along ``dim`` (a contiguous copy)."""
    return full.chunk(world_size(), dim)[process_index()].contiguous()


def reduce_scatter(full: torch.Tensor, dim: int, mean: bool) -> torch.Tensor:
    """The sum (or mean) over the processes of ``full``, this process's
    shard of it along ``dim``."""
    x = full.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // world_size(), *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM)
    if mean:
        out /= world_size()
    return out.movedim(0, dim).contiguous()


def all_gather(part: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from every process's shard along ``dim``."""
    x = part.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] * world_size(), *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x)
    return out.movedim(0, dim).contiguous()
