"""The parallel layout of training: processes, batch split, collectives.

Counterpart of ``diffbir_tpu/parallel/mesh.py``. The reference's
distributed surface is four collectives: allreduce(grad), allgather
(metrics), barrier and broadcast(init). JAX places arrays on a named mesh
and XLA inserts them; here each process drives one card and ``DataParallel``
runs them itself:

- ``make_mesh(n_data, n_tensor)`` lays the processes out as JAX's
  ``np.array(devices).reshape(n_data, n_tensor)`` does: global rank = data
  index x n_tensor + tensor index; a data group for each tensor index (the
  processes that split the batch) and a tensor group for each data index
  (the processes that split the weights, ``parallel/tp.py``). n_tensor = 1
  is the data-parallel layout over the whole process group;
- ``data_size`` holds ``train.n_data`` and the batch to the process count,
  raising the JAX package's errors;
- ``broadcast_`` copies rank 0's parameters to every process at start
  (JAX's ``replicate``);
- ``DataParallel.reduce`` reduces the fp32 gradients of the trained
  parameters over the data group before the optimiser's update: an
  all-reduce over buckets of whole leaves, or, for the leaves
  ``train.fsdp`` shards (``parallel/fsdp.py``), a reduce-scatter over
  buckets of them to each process's shards. The tensor group needs no
  reduction: its processes compute the same loss, and a sharded weight's
  gradient is whole on the process that holds the slice.

The reduction is a **sum** or a **mean**, as the loss is. Stage 1's loss is
a sum over the global batch (JAX differentiates ``jnp.sum`` over the batch
sharded across the mesh), so its gradients and loss are summed; stage 2's
is a batch mean, so they are averaged. An explicit reduction gives both
(``DistributedDataParallel`` only averages) and adds no hooks to stage 2's
checkpointed UNet and frozen models.

Collectives run whenever a process group is up, one process included;
without one every method is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import fsdp
from .distributed import process_index, world_size

REDUCTIONS = ("sum", "mean")


@dataclass(frozen=True)
class ProcessGrid:
    """The processes as an n_data x n_tensor grid (``make_mesh``): this
    process's indices and its two groups (None: the whole process group)."""

    n_data: int
    n_tensor: int
    data_index: int
    tensor_index: int
    data_group: Any = None
    tensor_group: Any = None


def make_mesh(n_data: Optional[int] = None, n_tensor: int = 1) -> ProcessGrid:
    """The grid of the process group (JAX's ``make_mesh(n_data, n_tensor)``):
    n_data defaults to the process count over n_tensor, and n_data x
    n_tensor must be the process count, else ValueError with JAX's text.
    Every process calls it together: it makes every group, in one order.
    A group of every process is the whole process group; without a process
    group the grid is 1 x 1."""
    n = world_size()
    if n_data is None:
        n_data = n // n_tensor
    if n_data * n_tensor != n:
        raise ValueError(f"make_mesh: need n_data*n_tensor == len(devices) but got "
                         f"{n_data}x{n_tensor} != {n} (one process per card: the processes "
                         f"of the group)")
    d, t = divmod(process_index(), n_tensor)

    def group(ranks):
        return None if len(ranks) == n else dist.new_group(ranks)

    data = tensor = None
    if dist.is_initialized():
        for j in range(n_tensor):
            g = group([i * n_tensor + j for i in range(n_data)])
            data = g if j == t else data
        for i in range(n_data):
            g = group([i * n_tensor + j for j in range(n_tensor)])
            tensor = g if i == d else tensor
    return ProcessGrid(n_data, n_tensor, d, t, data, tensor)


def data_size(n_data: Optional[int], batch_size: int) -> int:
    """The data-parallel size (the process count), after checking
    ``train.n_data`` (null or equal to it) and that ``batch_size``
    divides by it."""
    n = world_size()
    if n_data is not None and int(n_data) != n:
        raise ValueError(f"make_mesh: need n_data*n_tensor == len(devices) but got "
                         f"{int(n_data)}x1 != {n} (one process per card; train.n_data "
                         f"must be null or the process count)")
    if batch_size % n:
        raise ValueError(f"batch size must divide the data mesh: {batch_size} over {n} "
                         f"processes")
    return n


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Overwrite ``tensors`` (a module's parameters and buffers) with the
    first process's of ``group`` (default: rank 0 of the whole group), in
    place."""
    if dist.is_initialized():
        src = 0 if group is None else dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


class DataParallel:
    """The gradient (and metric) reduction of one training loop over the
    data group of ``grid`` (default: every process is a data index):
    ``reduce`` in ``REDUCTIONS``; ``fsdp`` shards the leaves ``fsdp_dim``
    names. A grid with n_tensor > 1 also tensor-shards the model
    (``train/stage2.py``'s ``init_train_state``)."""

    def __init__(self, reduce: str, fsdp: bool = False, grid: Optional[ProcessGrid] = None):
        if reduce not in REDUCTIONS:
            raise ValueError(f"reduce {reduce!r}: one of {REDUCTIONS}")
        self.mean = reduce == "mean"
        self.fsdp = fsdp
        self.active = dist.is_initialized()
        self.grid = grid or ProcessGrid(world_size(), 1, process_index(), 0)
        self.group = self.grid.data_group
        self.world = self.grid.n_data

    def shard_dim(self, shape: Sequence[int], tp_dim: Optional[int] = None) -> Optional[int]:
        """The dimension a leaf of this process's ``shape`` is sharded along
        over the data group, or None; ``tp_dim``: the dimension it is a
        tensor slice along (the rule reads the whole shape)."""
        if not (self.fsdp and self.active):
            return None
        whole = list(shape)
        if tp_dim is not None:
            whole[tp_dim] *= self.grid.n_tensor
        return fsdp.fsdp_dim(whole, self.world, taken=tp_dim)

    def _all_reduce(self, flat: torch.Tensor, mean: bool) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        if mean:
            flat /= self.world

    @torch.no_grad()
    def reduce(self, grads: List[torch.Tensor], dims: Sequence[Optional[int]]
               ) -> List[torch.Tensor]:
        """Each process's whole gradients -> their sum or mean over the
        processes: whole where ``dims`` is None (bucketed all-reduce), this
        process's shard along ``dims[i]`` otherwise (bucketed
        reduce-scatter)."""
        if not self.active:
            return list(grads)
        out = list(grads)
        whole = [i for i, d in enumerate(dims) if d is None]
        for bucket in fsdp.buckets([grads[i] for i in whole]):
            idx = [whole[j] for j in bucket]
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            self._all_reduce(flat, self.mean)
            off = 0
            for i in idx:
                n = out[i].numel()
                out[i] = flat[off:off + n].view_as(out[i])
                off += n
        sharded = [i for i, d in enumerate(dims) if d is not None]
        for bucket in fsdp.buckets([grads[i] for i in sharded]):
            idx = [sharded[j] for j in bucket]
            parts = fsdp.reduce_scatter([grads[i] for i in idx], [dims[i] for i in idx],
                                        self.mean, self.group)
            for i, part in zip(idx, parts):
                out[i] = part
        return out

    @torch.no_grad()
    def reduce_metric(self, x: torch.Tensor, mean: Optional[bool] = None) -> torch.Tensor:
        """A per-process metric -> its sum or mean over the processes (as
        the gradients are, unless ``mean`` says)."""
        if not self.active:
            return x
        x = x.detach().clone()
        self._all_reduce(x, self.mean if mean is None else mean)
        return x
