"""The collectives of tensor and spatial parallelism, as autograd Functions.

Under JAX a parallel layout is a sharding annotation, GSPMD inserts the
collectives of the forward, and ``jax.grad`` differentiates through them,
so the gradient is exact. Here each collective is explicit, on an explicit
``group``, and each carries its own backward (``Function.apply(x, group,
...)``):

- ``CopyToTensorParallel`` (Megatron's *f*): the input of a column
  layer, replicated over the tensor group. Identity forward; the backward
  all-reduces the input gradient, since each process's columns add their
  part of it. GSPMD: the all-reduce of a column-sharded matmul's input
  cotangent.
- ``ReduceFromTensorParallel`` (Megatron's *g*): a row layer's partial
  sums, all-reduced in fp32. Identity backward: the output and its
  gradient are replicated, so a summed backward would count the gradient
  once a process. GSPMD: the psum of a row-sharded matmul.
- ``HaloRows``: the rows above and below a band of NCHW rows, from the
  neighbouring processes; the backward sends each halo row's gradient back
  to the process that sent the row, where it adds to its boundary row.
  GSPMD: the halo exchange of a convolution over a sharded spatial axis.
- ``RowBelow``: the first row of the band below (zeros under the last
  band), as a stride-2 convolution after a bottom pad reads it (the VAE's
  ``Downsample``); the backward returns the row's gradient to its sender.
- ``CyclicRows``: ``torch.roll`` of the whole image by ``shift`` rows, on
  this band: the rows that leave one band enter its neighbour, and the
  image's last band and its first are neighbours (the shifted windows of
  SwinIR and SCUNet). Band r takes the first ``shift`` rows of band
  (r + 1) mod n for a roll up, the last rows of band (r - 1) mod n for a
  roll down; the backward is the opposite roll. GSPMD: the collective
  permute of a roll over a sharded axis.
- ``AllReduceSum``: a band's partial statistics summed over the bands.
  The backward all-reduces too: unlike *g*, each band's downstream differs,
  and every band's sum depends on every band's rows. GSPMD: a reduction
  over a sharded axis.
- ``GatherBands``: every band's rows (a self-attention's k and v) in rank
  order. The backward is a reduce-scatter: each band gets the sum, over
  every band's queries, of its own rows' gradients. GSPMD: an all-gather of
  a sharded operand, and its transpose.

Every process runs the same collectives in the same order, the backward's
and a checkpoint's recompute included, because every process runs the same
graph. The collectives are ``all_reduce`` and ``all_gather``, which gloo
(on CPU tensors, and on CUDA tensors of one card, staged through the host)
and nccl take; the reduce-scatter is an all-reduce and a slice, since gloo
has no reduce-scatter of CUDA tensors.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch.autograd import Function


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every process's ``t`` (equal shapes), in rank order. No backward."""
    t = t.contiguous()
    if dist.get_backend(group) == "nccl" and not t.is_cuda:
        return [p.cpu() for p in all_gather(t.cuda(), group)]
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, in a new tensor."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class CopyToTensorParallel(Function):
    """*f*: identity forward, all-reduce (fp32) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.float(), ctx.group).to(g.dtype), None


class ReduceFromTensorParallel(Function):
    """*g*: all-reduce forward in fp32, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.float(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class HaloRows(Function):
    """[top, bottom] (or [top] without ``below``) rows of NCHW ``x``'s band:
    the last row of the band above, the first row of the band below, zeros
    past the image's edges. One all-gather of each band's boundary rows
    forward, one of the halo rows' gradients backward."""

    @staticmethod
    def forward(ctx, x, group, below):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.below, ctx.shape = group, below, x.shape
        edges = torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2) if below else x[:, :, -1:]
        parts = all_gather(edges, group)
        zero = torch.zeros_like(x[:, :, :1])
        rows = [parts[rank - 1][:, :, -1:] if rank > 0 else zero]
        if below:
            rows.append(parts[rank + 1][:, :, :1] if rank < n - 1 else zero)
        return torch.cat(rows, dim=2)

    @staticmethod
    def backward(ctx, g):
        n, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        parts = all_gather(g, ctx.group)
        gx = g.new_zeros(ctx.shape)
        if rank < n - 1:  # the band below read this band's last row as its top
            gx[:, :, -1:] += parts[rank + 1][:, :, :1]
        if ctx.below and rank > 0:  # the band above read the first row as its bottom
            gx[:, :, :1] += parts[rank - 1][:, :, 1:2]
        return gx, None, None


class RowBelow(Function):
    """The first row of the band below NCHW ``x``'s band, zeros under the
    last band. One all-gather of each band's first row forward, one of
    the rows' gradients backward."""

    @staticmethod
    def forward(ctx, x, group):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.shape = group, x.shape
        parts = all_gather(x[:, :, :1], group)
        return parts[rank + 1] if rank < n - 1 else torch.zeros_like(parts[rank])

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        parts = all_gather(g, ctx.group)
        gx = g.new_zeros(ctx.shape)
        if rank > 0:  # the band above read this band's first row
            gx[:, :, :1] += parts[rank - 1]
        return gx, None


def cyclic_rows(x: torch.Tensor, group, shift: int, dim: int) -> torch.Tensor:
    """This band's rows (along ``dim``) of ``torch.roll`` of the whole
    image by ``shift`` rows. No backward (``CyclicRows`` has one)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    s, size = abs(shift), x.shape[dim]
    if s > size:
        raise ValueError(f"a roll of {shift} rows across bands of {size}")
    if shift < 0:  # up: this band's rows from s on, then the next band's first s
        parts = all_gather(x.narrow(dim, 0, s), group)
        return torch.cat([x.narrow(dim, s, size - s), parts[(rank + 1) % n]], dim=dim)
    parts = all_gather(x.narrow(dim, size - s, s), group)  # down: the band above's last s
    return torch.cat([parts[(rank - 1) % n], x.narrow(dim, 0, size - s)], dim=dim)


class CyclicRows(Function):
    """``cyclic_rows`` forward, the opposite roll backward."""

    @staticmethod
    def forward(ctx, x, group, shift, dim):
        ctx.group, ctx.shift, ctx.dim = group, shift, dim
        return cyclic_rows(x, group, shift, dim)

    @staticmethod
    def backward(ctx, g):
        return cyclic_rows(g.contiguous(), ctx.group, -ctx.shift, ctx.dim), None, None, None


class AllReduceSum(Function):
    """The sum over ``group``, forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class GatherBands(Function):
    """Every process's ``x`` concatenated along ``dim`` in rank order;
    backward, the sum over the processes of the gradient, this process's
    slice of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        total = _all_reduce(g, ctx.group)
        return total.narrow(ctx.dim, rank * ctx.size, ctx.size), None, None
