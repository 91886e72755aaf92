"""Inference over several processes, one card each: batch-, tile- and
spatial-parallel restoration.

Counterpart of ``diffbir_tpu/parallel/inference.py``. There each mode is a
sharding annotation and GSPMD inserts the collectives; here each process
runs its part and the collectives are explicit, on ``group`` (default: the
whole process group that ``parallel/distributed.py`` starts). Without a
process group every function is the plain run.

1. **Batch-parallel** (``shard_for_batch_parallel``, ``batch_parallel``):
   rank 0's parameters are broadcast, each process takes its rows of the
   batch (the noise tables too: they are drawn for the whole batch and
   split with it, so a row does not depend on the process count), and the
   outputs are all-gathered in rank order, so every process holds the
   whole batch (JAX reads the global array).
2. **Tile-parallel** (``tile_parallel_model_fn``): each process runs its
   tiles of a tile group through the model and the rows are all-gathered;
   **tile-sharded** (``make_tile_sharded_fn``): each process blends its
   tiles into an fp32 canvas, one all-reduce sums the canvases.
3. **Spatial-parallel** (``spatial_shard``, ``spatial_parallel``,
   ``gather``): one image's H axis is split into bands, one a process, and
   the ControlLDM denoiser (UNet + IRControlNet) runs on the bands through
   band-aware layers: 3x3 convolutions exchange a halo row with each
   neighbour, GroupNorm reduces its fp32 two-pass statistics over the
   bands, self-attention gathers k and v. The math is the single process's;
   the sums run in another order, so the result is equal within rounding
   (GSPMD's bit-equality does not carry over to reordered sums).

   Under autograd (guidance, training: a gradient with respect to ``x``,
   the condition or the weights) the band-aware layers differentiate
   through ``parallel/collectives.py``: the halo rows' gradients go back
   to their senders, the GroupNorm sums are all-reduced backward too, the
   gathered k and v are reduce-scattered. The gradients are a band's, as
   the output is; the parameters' gradients are each process's part, to
   be summed over the processes.

The collectives are ``all_reduce``, ``broadcast`` and ``all_gather``,
which gloo (CPU tensors; on one card, CUDA tensors staged through the host)
and nccl take.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import Conv2d, GroupNorm32, gn_fold_moments
from ..models.unet import CrossAttention, Downsample
from ..ops.attention import attention
from ..tiling import gaussian_weights, sliding_windows
from . import collectives
from .mesh import broadcast_
from .tp import check_default_mode


def _world(group=None) -> tuple:
    """(processes, this process's rank) of ``group``; (1, 0) without a
    process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


# --------------------------------------------------------------------------- #
# 1. batch-parallel
# --------------------------------------------------------------------------- #
def _rows(x, rank: int, n: int, axis: int):
    """This process's rows of ``x`` (a tensor or an array) along ``axis``."""
    if x.shape[axis] % n:
        raise ValueError(f"batch size must divide the data mesh: {x.shape[axis]} over {n} "
                         f"processes")
    per = x.shape[axis] // n
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, rank * per, per)
    return np.take(x, range(rank * per, (rank + 1) * per), axis=axis)


def shard_for_batch_parallel(module: torch.nn.Module, batch, group=None,
                             batch_axes: Optional[Mapping[str, int]] = None):
    """Rank 0's parameters and buffers of ``module`` on every process
    (``mesh.broadcast_``), and this process's rows of ``batch`` (a tensor,
    an array, or a mapping of them; ``batch_axes`` names the batch axis of
    an entry where it is not 0, e.g. 1 for a sampler's ``noise_table``
    [steps, B, ...]). Returns ``(module, rows)``."""
    broadcast_(list(module.parameters()) + list(module.buffers()), group)
    n, rank = _world(group)
    if n == 1:
        return module, batch
    axes = batch_axes or {}
    if isinstance(batch, Mapping):
        return module, {k: _rows(v, rank, n, axes.get(k, 0)) for k, v in batch.items()}
    return module, _rows(batch, rank, n, 0)


def _gather_rows(out, group):
    """Every process's rows of ``out`` (a tensor, or an array such as
    ``Pipeline.run``'s images) along axis 0, in rank order."""
    if isinstance(out, np.ndarray):
        return _gather_rows(torch.from_numpy(np.ascontiguousarray(out)), group).numpy()
    return torch.cat(collectives.all_gather(out, group), dim=0)


def batch_parallel(fn: Callable, group=None) -> Callable:
    """``fn`` on this process's rows (``shard_for_batch_parallel``), its
    output all-gathered in rank order: every process returns the whole
    batch's."""
    if not dist.is_initialized():
        return fn

    def wrapped(*args, **kwargs):
        return _gather_rows(fn(*args, **kwargs), group)

    return wrapped


# --------------------------------------------------------------------------- #
# 2. tile-parallel and tile-sharded
# --------------------------------------------------------------------------- #
def tile_parallel_model_fn(model_fn: Callable, group=None) -> Callable:
    """``model_fn`` (the ``fn`` of ``tiling.make_tiled_fn``) with the tiles
    of each call split over the processes: this process's whole tiles go
    through ``model_fn`` with their ``tile_coords``, and the rows are
    all-gathered. A tile count that does not divide is padded with copies
    of the last tile, whose rows are dropped."""
    if not dist.is_initialized():
        return model_fn
    takes_coords = "tile_coords" in inspect.signature(model_fn).parameters

    def wrapped(x_tiles, *args, tile_coords=(), **kwargs):
        n, rank = _world(group)
        coords = tuple(tile_coords)
        k = len(coords) if takes_coords and coords else x_tiles.shape[0]
        b = x_tiles.shape[0] // k  # rows of one tile (the image batch)
        pad = (-k) % n
        if pad:
            x_tiles = torch.cat([x_tiles] + [x_tiles[-b:]] * pad, dim=0)
            coords = coords + coords[-1:] * pad if coords else coords
        per = (k + pad) // n
        local = x_tiles[rank * per * b: (rank + 1) * per * b]
        if takes_coords and coords:
            out = model_fn(local, *args, tile_coords=coords[rank * per: (rank + 1) * per],
                           **kwargs)
        else:
            out = model_fn(local, *args, **kwargs)
        return torch.cat(collectives.all_gather(out, group), dim=0)[: k * b]

    return wrapped


def make_tile_sharded_fn(
    fn: Callable,
    size: int,
    stride: int,
    group=None,
    scale_type: str = "up",
    scale: int = 1,
    channel: Optional[int] = None,
    weight: str = "gaussian",
) -> Callable:
    """``tiling.make_tiled_fn`` with the tiles split over the processes:
    the tile list is padded to a multiple of the process count (padded
    tiles get weight 0), each process runs its contiguous block of tiles
    through ``fn`` in one call, blends them into an fp32 canvas, one
    all-reduce sums the canvases, and the sum is divided by the summed
    weights (times their reciprocal, as ``make_tiled_fn``). Batch 1 only.
    ``fn(tiles, *args, **kwargs)`` maps [N, size, size, C] -> [N, out, out,
    C'] and receives ``tile_coords`` (its tiles' corners) when its
    signature names it; ``weight``: "gaussian" or "ones"."""
    if scale_type not in ("up", "down"):
        raise ValueError(f"unknown scale type {scale_type!r}")
    if weight not in ("gaussian", "ones"):
        raise ValueError(f"unknown tile weight {weight!r}: gaussian or ones")

    def sfn(v: int) -> int:
        return v * scale if scale_type == "up" else v // scale

    osize = sfn(size)
    wmask = gaussian_weights(osize, osize) if weight == "gaussian" else np.ones((osize, osize))
    takes_coords = "tile_coords" in inspect.signature(fn).parameters

    def tiled(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        b, h, w, c = x.shape
        if b != 1:
            raise ValueError("the tile-sharded path is the single-image high-res mode: batch 1")
        n, rank = _world(group)
        coords = sliding_windows(h, w, size, stride)
        count = np.zeros((sfn(h), sfn(w), 1), np.float32)
        for hi, wi in coords:
            count[sfn(hi): sfn(hi) + osize, sfn(wi): sfn(wi) + osize, 0] += wmask
        pad = (-len(coords)) % n
        coords_pad = coords + coords[-1:] * pad
        per = len(coords_pad) // n
        mine = range(rank * per, (rank + 1) * per)
        local = [coords_pad[i] for i in mine]
        tiles = torch.cat([x[:, hi: hi + size, wi: wi + size] for hi, wi in local], dim=0)
        if takes_coords:
            res = fn(tiles, *args, tile_coords=tuple(local), **kwargs)
        else:
            res = fn(tiles, *args, **kwargs)
        mask = torch.as_tensor(wmask[None, :, :, None], dtype=torch.float32, device=x.device)
        res = res.float() * mask
        canvas = torch.zeros((1, sfn(h), sfn(w), channel or c), dtype=torch.float32,
                             device=x.device)
        for j, i in enumerate(mine):
            if i >= len(coords):  # a padded tile: weight 0
                continue
            hi, wi = coords_pad[i]
            canvas[:, sfn(hi): sfn(hi) + osize, sfn(wi): sfn(wi) + osize] += res[j: j + 1]
        if n > 1:
            dist.all_reduce(canvas, op=dist.ReduceOp.SUM, group=group)
        return canvas * torch.as_tensor(1.0 / count, device=x.device)[None]

    return tiled


# --------------------------------------------------------------------------- #
# 3. spatial-parallel
# --------------------------------------------------------------------------- #
def spatial_shard(x: torch.Tensor, group=None) -> torch.Tensor:
    """This process's band of the H axis of an NHWC image or latent (JAX's
    ``P(None, axis)``): band r of n equal ones."""
    n, rank = _world(group)
    if x.shape[1] % n:
        raise ValueError(f"spatial_shard: H {x.shape[1]} does not divide over {n} processes")
    return x.chunk(n, dim=1)[rank] if n > 1 else x


def gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The whole NHWC tensor, on every process, from each process's H band
    (``spatial_shard``'s inverse)."""
    if not dist.is_initialized():
        return x
    return torch.cat(collectives.all_gather(x, group), dim=1)


def _halo_rows(x: torch.Tensor, group, below: bool):
    """The row above this band and (with ``below``) the row below it, from
    the neighbouring processes' bands of NCHW ``x``; zeros past the image's
    edges (a 3x3 convolution's zero padding). One all-gather of each band's
    boundary rows (``collectives.HaloRows``: the backward returns the
    rows' gradients to their senders)."""
    rows = collectives.HaloRows.apply(x, group, below)
    return rows[:, :, :1], (rows[:, :, 1:] if below else None)


def _band_conv(m: Conv2d, group, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 convolution (stride 1 or 2, padding 1) of this band: the halo
    rows above (and, at stride 1, below) it, then the convolution padded in
    W only. A stride-2 band starts on an even row, so its output rows read
    the row above it and none below."""
    x = x.to(m.weight.dtype)
    top, bottom = _halo_rows(x, group, below=m.stride[0] == 1)
    xp = torch.cat([top, x] if bottom is None else [top, x, bottom], dim=2)
    return F.conv2d(xp, m.weight, m.bias, m.stride, (0, m.padding[1]))


def _band_moments(xf: torch.Tensor, group):
    """Per-channel fp32 mean and two-pass variance of NC... ``xf`` over
    every band: one all-reduce of the sums, then one of the centred
    squares (the bands are of equal size), each all-reduced backward too
    (``collectives.AllReduceSum``)."""
    axes = tuple(range(2, xf.dim()))
    count = dist.get_world_size(group) * math.prod(xf.shape[2:])
    total = collectives.AllReduceSum.apply
    mean = total(xf.sum(dim=axes, keepdim=True), group) / count
    d = xf - mean
    return mean, total((d * d).sum(dim=axes, keepdim=True), group) / count


def _band_group_norm(m: GroupNorm32, group, x: torch.Tensor) -> torch.Tensor:
    """``GroupNorm32`` of this band with the whole image's statistics
    (``_band_moments``), folded and applied as the module does."""
    mean, var = _band_moments(x.float(), group)
    a, b = gn_fold_moments(mean.flatten(1), var.flatten(1), m.weight.float(), m.bias.float(),
                           m.num_groups, m.eps)
    return x * a.reshape(mean.shape).to(x.dtype) + b.reshape(mean.shape).to(x.dtype)


def _band_attention(m: CrossAttention, group, x: torch.Tensor,
                    context: Optional[torch.Tensor] = None,
                    kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention of this band's tokens (a contiguous range of the
    row-major token order) to every band's: k and v all-gathered in rank
    order, one gather of both (``collectives.GatherBands``: reduce-scattered
    backward). Cross-attention to the context is local."""
    if context is not None or kv is not None:
        return CrossAttention.forward(m, x, context, kv)
    b, sq, _ = x.shape
    q = m.to_q(x)
    k, v = collectives.GatherBands.apply(torch.cat([m.to_k(x), m.to_v(x)], dim=-1),
                                         group, 1).chunk(2, dim=-1)
    skv = k.shape[1]
    q = q.reshape(b, sq, m.heads, m.dim_head)
    k = k.reshape(b, skv, m.heads, m.dim_head)
    v = v.reshape(b, skv, m.heads, m.dim_head)
    out = attention(q, k, v, impl=m.attn_impl, layout=m.flash_layout, kv_gathered=True)
    return m.to_out(out.reshape(b, sq, -1))


def _band_layers(roots: Iterable[torch.nn.Module], group):
    """(module, its band-aware forward) for every layer of ``roots`` that
    reads across rows: 3x3 convolutions, GroupNorms, self-attention."""
    for root in roots:
        for m in root.modules():
            if isinstance(m, Conv2d) and m.kernel_size != (1, 1):
                if m.kernel_size != (3, 3) or m.padding != (1, 1) or m.stride[0] not in (1, 2):
                    raise ValueError(f"spatial parallelism: no banded form of {m}")
                yield m, (lambda x, m=m: _band_conv(m, group, x))
            elif isinstance(m, GroupNorm32):
                if m.cross_batch:
                    raise ValueError("spatial parallelism: a cross-batch GroupNorm")
                yield m, (lambda x, m=m: _band_group_norm(m, group, x))
            elif isinstance(m, CrossAttention):
                yield m, (lambda x, context=None, kv=None, m=m:
                          _band_attention(m, group, x, context, kv))


@contextlib.contextmanager
def _banded(roots, group):
    """The band-aware forwards installed on the layers of ``roots`` while
    in this context (the modules and their weights are not changed)."""
    installed = []
    try:
        for m, forward in _band_layers(roots, group):
            m.forward = forward
            installed.append(m)
        yield
    finally:
        for m in installed:
            del m.forward


class SpatialParallel:
    """The ControlLDM denoiser on this process's H band; see
    ``spatial_parallel``."""

    def __init__(self, cldm, group):
        self.cldm, self.group = cldm, group
        self.factor = 2 ** sum(isinstance(m, Downsample) for m in cldm.unet.modules())
        self._context = None

    def __enter__(self) -> "SpatialParallel":
        if self._context is not None:
            raise RuntimeError("spatial_parallel: the banded forwards are installed already")
        roots = (self.cldm.unet, self.cldm.controlnet) if dist.is_initialized() else ()
        self._context = _banded(roots, self.group)
        self._context.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        context, self._context = self._context, None
        context.__exit__(*exc)

    def _recomputes(self, x, cond) -> bool:
        """Whether autograd records a graph whose backward recomputes a
        checkpointed block."""
        if not torch.is_grad_enabled():
            return False
        inputs = [x, *(v for v in cond.values() if isinstance(v, torch.Tensor))]
        grad = any(t.requires_grad for t in inputs) or any(
            p.requires_grad for p in self.cldm.parameters())
        return grad and any(getattr(m, "use_checkpoint", False) for m in self.cldm.modules())

    def __call__(self, x, t, cond, control_scales=1.0, hoisted=None):
        cldm = self.cldm
        if not dist.is_initialized():
            return cldm(x, t, cond, control_scales, hoisted)
        n, _ = _world(self.group)
        band = x.shape[1]
        if band % self.factor:
            raise ValueError(f"spatial parallelism: the latent H {band * n} must divide by "
                             f"{self.factor} x {n} processes = {self.factor * n}, so that each "
                             f"band keeps whole rows at every level")
        if cond["c_img"].shape[1] != band:
            raise ValueError(f"the condition's band has {cond['c_img'].shape[1]} rows, x's "
                             f"{band}: shard both with spatial_shard")
        if self._context is not None:
            return cldm(x, t, cond, control_scales, hoisted)
        if self._recomputes(x, cond):
            raise RuntimeError("spatial parallelism under autograd with gradient "
                               "checkpointing: the backward recomputes the banded layers, so "
                               "run the forward and the backward inside `with fn:` (fn = "
                               "spatial_parallel(cldm))")
        with _banded((cldm.unet, cldm.controlnet), self.group):
            return cldm(x, t, cond, control_scales, hoisted)


def spatial_parallel(cldm, group=None) -> SpatialParallel:
    """The ControlLDM denoiser (``fn(x, t, cond, control_scales,
    hoisted)``: IRControlNet -> scaled residuals -> UNet) on this process's
    H band of ``x`` and ``cond["c_img"]`` (NHWC, ``spatial_shard``); ``t``,
    ``cond["c_txt"]`` and the hoisted rows are replicated. Returns this
    band's output; ``gather`` makes the whole (it has no backward: take a
    band's loss on the band). The latent H must divide by 2^d * n (d the
    UNet's downsamples: 8 n for SD2.1), so that every band keeps whole rows
    at every level. The default serving mode only.

    Each call installs the band-aware forwards for its own span. Under
    autograd with gradient checkpointing (``use_checkpoint``), the
    backward recomputes the checkpointed blocks, which must run banded too:
    the caller then holds them installed over the forward and the backward
    with ``with fn: loss_of(fn(...)).backward()``; such a call outside the
    context raises RuntimeError. Without a process group, ``fn`` is the
    plain denoiser."""
    if dist.is_initialized():
        for root in (cldm.unet, cldm.controlnet):
            check_default_mode(root, "spatial parallelism (spatial_parallel)")
    return SpatialParallel(cldm, group)
