"""Sharded optimiser state over the processes (``train.fsdp: true``).

Counterpart of ``diffbir_tpu/parallel/fsdp.py``: ``fsdp_dim`` is
``fsdp_spec``'s rule (shard a leaf along its largest dimension that divides
by the number of processes of the data axis, the first such on ties, past
the dimension tensor parallelism shards; replicate a leaf where none does,
and every leaf of a single process). Here the rule places the optimiser's
fp32 masters and both AdamW moments: each process keeps and updates its
own shard (``train/optim.py``), the gradients are reduce-scattered to it
and the updated weights, rounded to the module's dtype, all-gathered back,
all over the data group (``parallel/mesh.py``'s grid; the whole process
group by default). Under tensor parallelism each process shards its
tensor slice.

The module's weights stay whole on every process. That is ZeRO-2 (sharded
optimiser state and gradient reduction), where JAX's GSPMD placement also
shards the weights between uses (ZeRO-3); the arithmetic, and so the
numbers, are the same.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

# the bytes of one bucket of gradients or weights reduced or gathered at once
BUCKET_BYTES = 64 << 20


def fsdp_dim(shape: Sequence[int], n_data: int, taken: Optional[int] = None) -> Optional[int]:
    """The dimension a leaf of ``shape`` (its whole shape) is sharded along
    over ``n_data`` processes, or None to replicate it (``fsdp_spec``;
    ``taken``: the dimension tensor parallelism shards it along, which the
    data axis leaves alone)."""
    if len(shape) == 0 or n_data <= 1:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if i != taken and shape[i] % n_data == 0:
            return i
    return None


def _size_rank(group) -> tuple:
    """(processes, this process's rank) of ``group`` (None: the whole
    process group); (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def shard(full: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This process's shard of ``full`` along ``dim`` over ``group`` (a
    contiguous copy)."""
    n, rank = _size_rank(group)
    return full.chunk(n, dim)[rank].contiguous()


def buckets(tensors: Sequence[torch.Tensor], limit: int = BUCKET_BYTES) -> Iterator[List[int]]:
    """The indices of ``tensors`` in groups of one dtype, in order, each
    closed once it holds ``limit`` bytes: one collective a group."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        group, size = [], 0
        for i in idx:
            group.append(i)
            size += tensors[i].numel() * tensors[i].element_size()
            if size >= limit:
                yield group
                group, size = [], 0
        if group:
            yield group


def reduce_scatter(fulls: Sequence[torch.Tensor], dims: Sequence[int], mean: bool,
                   group=None) -> List[torch.Tensor]:
    """The sum (or mean) over ``group`` of each of ``fulls`` (one dtype),
    this process's shard of it along its dimension in ``dims``: one
    collective for them all. gloo has no reduce-scatter of CUDA tensors:
    there it is an all-reduce and a slice."""
    n, rank = _size_rank(group)
    rows = [f.movedim(d, 0).reshape(n, -1) for f, d in zip(fulls, dims)]  # row r: rank r's
    x = torch.cat(rows, dim=1)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        part = x[rank]
    else:
        part = torch.empty(x.shape[1], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(part, x.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    if mean:
        part /= n
    out, off = [], 0
    for f, d, r in zip(fulls, dims, rows):
        shape = list(f.movedim(d, 0).shape)
        shape[0] //= n
        out.append(part[off:off + r.shape[1]].view(shape).movedim(0, d).contiguous())
        off += r.shape[1]
    return out


def all_gather(parts: Sequence[torch.Tensor], dims: Sequence[int],
               group=None) -> List[torch.Tensor]:
    """The whole tensors from every process's shards ``parts`` (one dtype)
    along their dimensions in ``dims`` over ``group``: one collective for
    them all."""
    n, _ = _size_rank(group)
    moved = [p.movedim(d, 0) for p, d in zip(parts, dims)]
    flat = torch.cat([m.reshape(-1) for m in moved])
    out = torch.empty(n * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    out = out.view(n, flat.numel())
    wholes, off = [], 0
    for m, d in zip(moved, dims):
        k = m.numel()
        whole = out[:, off:off + k].reshape(n * m.shape[0], *m.shape[1:])
        wholes.append(whole.movedim(0, d).contiguous())
        off += k
    return wholes
