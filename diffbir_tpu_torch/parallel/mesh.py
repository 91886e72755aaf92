"""The data-parallel layout of training: processes, batch split, collectives.

Counterpart of ``diffbir_tpu/parallel/mesh.py``. The reference's
distributed surface is four collectives: allreduce(grad), allgather
(metrics), barrier and broadcast(init). JAX places arrays on a named mesh
and XLA inserts them; here each process drives one card and ``DataParallel``
runs them itself:

- ``data_size`` holds ``train.n_data`` and the batch to the process count,
  raising the JAX package's errors;
- ``broadcast_`` copies rank 0's parameters to every process at start
  (JAX's ``replicate``);
- ``DataParallel.reduce`` reduces the fp32 gradients of the trained
  parameters before the optimiser's update: an all-reduce over buckets of
  whole leaves, or, for the leaves ``train.fsdp`` shards
  (``parallel/fsdp.py``), a reduce-scatter to each process's shard.

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

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import fsdp
from .distributed import world_size

REDUCTIONS = ("sum", "mean")
BUCKET_BYTES = 64 << 20


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
    """The gradient (and metric) reduction of one training loop: ``reduce``
    in ``REDUCTIONS``; ``fsdp`` shards the leaves ``fsdp_dim`` names."""

    def __init__(self, reduce: str, fsdp: bool = False):
        if reduce not in REDUCTIONS:
            raise ValueError(f"reduce {reduce!r}: one of {REDUCTIONS}")
        self.mean = reduce == "mean"
        self.fsdp = fsdp
        self.active = dist.is_initialized()
        self.world = world_size()

    def shard_dim(self, shape: Sequence[int]) -> Optional[int]:
        """The dimension a leaf of ``shape`` is sharded along, or None."""
        return fsdp.fsdp_dim(shape, self.world) if self.fsdp and self.active else None

    def _all_reduce(self, flat: torch.Tensor, mean: bool) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        if mean:
            flat /= self.world

    @torch.no_grad()
    def reduce(self, grads: List[torch.Tensor], dims: Sequence[Optional[int]]
               ) -> List[torch.Tensor]:
        """Each process's whole gradients -> their sum or mean over the
        processes: whole where ``dims`` is None (bucketed all-reduce), this
        process's shard along ``dims[i]`` otherwise (reduce-scatter)."""
        if not self.active:
            return list(grads)
        out = list(grads)
        bucket: List[int] = []
        size = 0

        def flush():
            nonlocal bucket, size
            if not bucket:
                return
            flat = torch.cat([out[i].reshape(-1) for i in bucket])
            self._all_reduce(flat, self.mean)
            off = 0
            for i in bucket:
                n = out[i].numel()
                out[i] = flat[off:off + n].view_as(out[i])
                off += n
            bucket, size = [], 0

        for i, (g, d) in enumerate(zip(grads, dims)):
            if d is not None:
                out[i] = fsdp.reduce_scatter(g, d, self.mean)
                continue
            bucket.append(i)
            size += g.numel() * g.element_size()
            if size >= BUCKET_BYTES:
                flush()
        flush()
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
