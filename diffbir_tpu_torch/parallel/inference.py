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
   ``gather``, ``spatial_parallel_request``): one image's H axis is split
   into bands, one a process, and every model of the restoration path runs
   on the bands through band-aware layers: the ControlLDM denoiser (UNet +
   IRControlNet), the VAE's encode and decode, and the cleaners SwinIR,
   SCUNet and BSRNet. 3x3 convolutions exchange a halo row with each
   neighbour; the VAE's ``Downsample`` (a bottom pad, then a stride-2
   convolution without padding) takes the row below its band only, zeros
   under the last band; GroupNorm reduces its fp32 two-pass statistics
   over the bands; self-attention (the UNet's, the VAE's d = 512 mid-block)
   gathers k and v; the shifted windows of SwinIR and SCUNet roll their
   rows cyclically across the bands (``collectives.CyclicRows``, the last
   band's neighbour below is the first) and take their band's window rows
   of the whole image's mask. The rest is local to a band: k2s2
   convolutions and transposed convolutions, nearest x2 upsamples,
   ``PixelUnshuffle``, 1x1 convolutions, LayerNorm, window attention; each
   wrapper checks that the band's rows divide at every level. The math is
   the single process's; the sums run in another order, so the result is
   equal within rounding (GSPMD's bit-equality does not carry over to
   reordered sums).

   Every serving mode of the ControlLDM is banded. K4 (the int8 dense
   layers) and K7 (the fused GEGLU FFN) work token by token and run on a
   band unchanged; the packed K3 takes a band's queries against the
   gathered k and v. A fused ResBlock (K6, float or int8 convs) gathers
   every band's rows, runs K6 on the whole image's rows and keeps its
   band's rows of the output: what GSPMD does around a ``pallas_call``,
   which it cannot partition, so the math is JAX's. Each process then
   computes every ResBlock whole and holds one block's whole activation
   for the span of the call.

   Under autograd (guidance, training: a gradient with respect to ``x``,
   the condition or the weights) the band-aware layers differentiate
   through ``parallel/collectives.py``: the halo rows' gradients go back
   to their senders, the GroupNorm sums are all-reduced backward too, the
   gathered k and v, and a fused ResBlock's gathered rows, are
   reduce-scattered. The gradients are a band's, as
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

from ..models.bsrnet import RRDBNet
from ..models.layers import Conv2d, GroupNorm32, gn_fold_moments
from ..models.scunet import SCUNet, WMSA
from ..models.swinir import SCALE, Band, SwinBlock, SwinIR
from ..models.unet import CrossAttention, Downsample, ResBlock
from ..models.vae import AttnBlock, AutoencoderKL
from ..models.vae import Downsample as VAEDownsample
from ..ops.attention import attention
from ..pipeline import CleanerPipeline, build_sampler, model_function
from ..tiling import gaussian_weights, sliding_windows
from ..utils.common import wavelet_reconstruction
from . import collectives
from .mesh import broadcast_


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


def _row_below(x: torch.Tensor, group) -> torch.Tensor:
    """The first row of the band below NCHW ``x``'s, zeros under the last
    band (``collectives.RowBelow``)."""
    return collectives.RowBelow.apply(x, group)


def _band_downsample(m: VAEDownsample, group, x: torch.Tensor) -> torch.Tensor:
    """The VAE's ``Downsample`` of this band: the row below it (the bottom
    pad under the last band), the right pad, then the stride-2 convolution
    without padding. A band starts on an even row, so its output rows read
    no row above it."""
    x = x.to(m.conv.weight.dtype)
    xp = F.pad(torch.cat([x, _row_below(x, group)], dim=2), (0, 1))
    return F.conv2d(xp, m.conv.weight, m.conv.bias, m.conv.stride)


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


def _band_fused_resblock(m: ResBlock, group, x: torch.Tensor, emb: Optional[torch.Tensor],
                         emb_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A fused ResBlock (K6) of this band of NCHW ``x``: every band's rows
    gathered in rank order (``collectives.GatherBands``: reduce-scattered
    backward), K6 on the whole image's rows, this band's rows of its
    output."""
    n, rank = _world(group)
    whole = collectives.GatherBands.apply(x, group, 2)
    return ResBlock.forward(m, whole, emb, emb_out).chunk(n, dim=2)[rank].contiguous()


def _band_vae_attention(m: AttnBlock, group, x: torch.Tensor) -> torch.Tensor:
    """The VAE's single-head mid-block attention of this band's tokens to
    every band's: q local, k and v all-gathered in rank order
    (``collectives.GatherBands``), the call ``kv_gathered`` (K1_wide from
    the whole image's ``FLASH_MIN_WIDE`` tokens)."""
    b, c, h, w = x.shape
    tok = m.norm(x).flatten(2).transpose(1, 2)
    q = m._tokens_linear(tok, m.q).reshape(b, h * w, 1, c)
    kv = collectives.GatherBands.apply(
        torch.cat([m._tokens_linear(tok, m.k), m._tokens_linear(tok, m.v)], dim=-1), group, 1)
    k, v = (t.reshape(b, kv.shape[1], 1, c) for t in kv.chunk(2, dim=-1))
    out = attention(q, k, v, impl=m.attn_impl, kv_gathered=True).reshape(b, h * w, c)
    out = m._tokens_linear(out, m.proj_out)
    return x + out.transpose(1, 2).reshape(b, c, h, w)


def _roll_rows(y: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``torch.roll`` of the whole NHWC image by ``shift`` rows, on this
    band (``collectives.CyclicRows``)."""
    return collectives.CyclicRows.apply(y, group, shift, 1)


def _band(h: int, group) -> Band:
    """This process's ``Band`` of a tensor whose bands have ``h`` rows."""
    n, rank = _world(group)
    return Band(h * n, rank * h, lambda y, shift: _roll_rows(y, group, shift))


def _band_layers(roots: Iterable[torch.nn.Module], group):
    """(module, its band-aware forward) for every layer of ``roots`` that
    reads across rows: 3x3 convolutions, the VAE's ``Downsample``,
    GroupNorms, fused ResBlocks (whose layers K6 reads, not calls),
    self-attention (the UNet's and the VAE's), shifted windows (SwinIR's
    ``SwinBlock``, SCUNet's ``WMSA``). A convolution whose kernel equals its
    stride without padding (SCUNet's k2s2) is local."""
    for root in roots:
        inner = {id(m.conv) for m in root.modules() if isinstance(m, VAEDownsample)}
        inner.update(id(c) for m in root.modules() if isinstance(m, ResBlock) and m.fused
                     for c in m.modules() if c is not m)
        for m in root.modules():
            if id(m) in inner:
                continue
            if isinstance(m, ResBlock) and m.fused:
                yield m, (lambda x, emb, emb_out=None, m=m:
                          _band_fused_resblock(m, group, x, emb, emb_out))
            elif isinstance(m, VAEDownsample):
                yield m, (lambda x, m=m: _band_downsample(m, group, x))
            elif isinstance(m, Conv2d) and m.kernel_size != (1, 1):
                if m.kernel_size == m.stride and m.padding == (0, 0):
                    continue
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
            elif isinstance(m, AttnBlock):
                yield m, (lambda x, m=m: _band_vae_attention(m, group, x))
            elif isinstance(m, SwinBlock):
                yield m, (lambda x, x_size, m=m:
                          SwinBlock.forward(m, x, x_size, _band(x_size[0], group)))
            elif isinstance(m, WMSA):
                yield m, (lambda x, m=m: WMSA.forward(m, x, _band(x.shape[1], group)))


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


def _check_rows(what: str, band: int, factor: int, group) -> None:
    """ValueError unless a band of ``band`` rows keeps whole rows at every
    level of a model whose rows must divide by ``factor``."""
    n, _ = _world(group)
    if band % factor or band == 0:
        raise ValueError(f"spatial parallelism: the {what} H {band * n} must divide by "
                         f"{factor} x {n} processes = {factor * n}, so that each band keeps "
                         f"whole rows at every level")


class SpatialParallelVAE:
    """The VAE's ``encode_moments`` and ``decode`` on this process's H band
    (NCHW), its bands' results; see ``spatial_parallel``."""

    def __init__(self, vae: AutoencoderKL, group):
        self.vae, self.group = vae, group
        self.factor = 2 ** sum(isinstance(m, VAEDownsample) for m in vae.encoder.modules())

    def banded(self, root: torch.nn.Module, rows: int, factor: int, what: str):
        """The band-aware forwards of ``root`` (the encoder or the decoder)
        installed for a band of ``rows`` rows; nothing without a process
        group."""
        _check_rows(what, rows, factor, self.group)
        return _banded((root,), self.group) if dist.is_initialized() else contextlib.nullcontext()

    def encode_moments(self, x: torch.Tensor):
        """This band of the image in [-1, 1] -> its band of (mean, logvar)."""
        with self.banded(self.vae.encoder, x.shape[2], self.factor, "image"):
            return self.vae.encode_moments(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """This band of the latent -> its band of the image."""
        with self.banded(self.vae.decoder, z.shape[2], 1, "latent"):
            return self.vae.decode(z)


class SpatialParallelCleaner:
    """A cleaner (SwinIR, SCUNet, BSRNet) on this process's H band (NHWC in
    [0, 1]), its band of the output; see ``spatial_parallel``."""

    def __init__(self, model: torch.nn.Module, group):
        self.model, self.group = model, group
        if isinstance(model, SwinIR):  # x8 pixel unshuffle, then whole windows
            self.factor = SCALE * model.window_size
        elif isinstance(model, SCUNet):  # its edge pad's multiple
            self.factor = 64
        else:
            self.factor = 1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not dist.is_initialized():
            return self.model(x)
        _check_rows("image", x.shape[1], self.factor, self.group)
        with _banded((self.model,), self.group):
            return self.model(x)


class SpatialParallel:
    """The ControlLDM denoiser on this process's H band, and its VAE's
    encode and decode; see ``spatial_parallel``."""

    def __init__(self, cldm, group):
        self.cldm, self.group = cldm, group
        self.factor = 2 ** sum(isinstance(m, Downsample) for m in cldm.unet.modules())
        self.vae = SpatialParallelVAE(cldm.vae, group)
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
        band = x.shape[1]
        _check_rows("latent", band, self.factor, self.group)
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

    def vae_encode(self, image: torch.Tensor, sample: bool = True,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``ControlLDM.vae_encode`` of this band of ``image`` (NHWC in [-1,
        1]), banded; a posterior sample takes this band of the whole
        latent's ``eps``, given or drawn from ``generator`` (so no band's
        noise depends on the process count)."""
        cldm, f = self.cldm, self.vae.factor
        with self.vae.banded(cldm.vae.encoder, image.shape[1], f, "image"):
            if sample and eps is None:
                if generator is None:
                    raise ValueError("sampling the posterior needs a generator or eps")
                n, _ = _world(self.group)
                shape = (image.shape[0], image.shape[1] * n // f, image.shape[2] // f,
                         cldm.vae.quant_conv.out_channels // 2)
                eps = torch.randn(shape, generator=generator, device=image.device)
            if eps is not None:
                eps = spatial_shard(eps, self.group)
            return cldm.vae_encode(image, sample=sample, eps=eps)

    def vae_decode(self, z: torch.Tensor) -> torch.Tensor:
        """``ControlLDM.vae_decode`` of this band of the latent ``z``
        (NHWC), banded: this band of the image."""
        with self.vae.banded(self.cldm.vae.decoder, z.shape[1], 1, "latent"):
            return self.cldm.vae_decode(z)


def spatial_parallel(model, group=None):
    """``model`` on this process's H band; ``spatial_shard`` makes a band,
    ``gather`` the whole from the bands (it has no backward: take a band's
    loss on the band). A ControlLDM in any serving mode (see the module's
    notes). Without a process group each wrapper is the plain model.

    - A ControlLDM: the denoiser (``fn(x, t, cond, control_scales,
      hoisted)``: IRControlNet -> scaled residuals -> UNet) on the band of
      ``x`` and ``cond["c_img"]`` (NHWC); ``t``, ``cond["c_txt"]`` and the
      hoisted rows are replicated. Returns this band's output. The latent H
      must divide by 2^d * n (d the UNet's downsamples: 8 n for SD2.1).
      ``fn.vae_encode`` and ``fn.vae_decode`` are the VAE's, banded, as
      the ControlLDM's methods.
    - An ``AutoencoderKL``: ``encode_moments`` and ``decode`` of a band
      (NCHW); the image H must divide by 2^d * n (d its downsamples: 8 n
      for SD2.1), the latent's by n.
    - ``SwinIR``, ``SCUNet``, ``RRDBNet`` (BSRNet): the forward of a band
      (NHWC in [0, 1]); the image H must divide by 64 n for SwinIR (its x8
      pixel unshuffle, then windows of 8) and SCUNet (its edge pad's
      multiple), by n for BSRNet. W is padded on each band as on the whole.

    Each wrapper raises ValueError, naming the factor, for an H that does
    not split into bands of whole rows at every level.

    The denoiser installs the band-aware forwards for each call's span.
    Under autograd with gradient checkpointing (``use_checkpoint``), the
    backward recomputes the checkpointed blocks, which must run banded too:
    the caller then holds them installed over the forward and the backward
    with ``with fn: loss_of(fn(...)).backward()``; such a call outside the
    context raises RuntimeError."""
    if isinstance(model, AutoencoderKL):
        return SpatialParallelVAE(model, group)
    if isinstance(model, (SwinIR, SCUNet, RRDBNet)):
        return SpatialParallelCleaner(model, group)
    return SpatialParallel(model, group)


@torch.no_grad()
def spatial_parallel_request(pipe: CleanerPipeline, lq: np.ndarray, x_T: torch.Tensor,
                             steps: int, strength: float = 1.0, pos_prompt: str = "",
                             neg_prompt: str = "", cfg_scale: float = 4.0,
                             sampler_type: str = "spaced",
                             noise_table: Optional[torch.Tensor] = None,
                             group=None) -> np.ndarray:
    """One restoration request banded over the processes from end to end:
    the cleaner, the VAE encode, the denoiser at every step, the decode on
    this process's H band, then the gathered image's colour fix; every
    process returns the whole uint8 image, as ``pipe.run`` would (the
    output at the input's size: no resize).

    ``lq``: uint8 [1, H, W, 3], the cleaner's input at the output size (a
    SwinIR or SCUNet pipeline: an x1 cleaner), H a multiple of 64 n, W of
    64, both at least ``pipe.min_cond_size``. The noise is the whole
    request's, each process taking its band: ``x_T`` [1, H/8, W/8, 4] and,
    for a sampler that draws, ``noise_table`` (the sampler's layout, H on
    its third axis from the end)."""
    n, rank = _world(group)
    cldm, device = pipe.cldm, pipe.device
    if not isinstance(pipe.cleaner, (SwinIR, SCUNet)):
        raise ValueError("spatial_parallel_request runs an x1 cleaner: a SwinIR or SCUNet "
                         "pipeline")
    lq_t = torch.as_tensor(np.asarray(lq), device=device).float().div(255.0).clamp(0, 1)
    b, h, w, _ = lq_t.shape
    if b != 1 or h % (64 * n) or w % 64 or min(h, w) < pipe.min_cond_size:
        raise ValueError(f"spatial_parallel_request: one image with H a multiple of 64 x {n} "
                         f"processes, W of 64, both at least {pipe.min_cond_size}; got "
                         f"{tuple(lq_t.shape)}")
    cond_img = spatial_parallel(pipe.cleaner, group)(spatial_shard(lq_t, group)).clamp(0, 1)
    fn = spatial_parallel(cldm, group)
    c_img = fn.vae_encode(cond_img * 2 - 1, sample=False)
    cond = {"c_txt": cldm.encode_text(pipe.tokenize(pos_prompt, 1)), "c_img": c_img}
    uncond = None
    if cfg_scale != 1.0:
        uncond = {"c_txt": cldm.encode_text(pipe.tokenize(neg_prompt, 1)), "c_img": c_img}
    sampler = build_sampler(sampler_type, pipe.schedule, False)
    tables = None
    if pipe.hoist:
        ctx = cond["c_txt"] if uncond is None else torch.cat([cond["c_txt"], uncond["c_txt"]])
        tables = cldm.make_hoist_tables(ctx, sampler.model_ts(steps))
    if noise_table is not None:
        noise_table = noise_table.to(device).chunk(n, dim=noise_table.dim() - 3)[rank]
    start = spatial_shard(x_T.to(device, torch.float32), group)
    z = sampler.sample(model_function(fn, strength, tables), start, cond, uncond, cfg_scale,
                       steps, generator=None, noise_table=noise_table)
    sample = gather(fn.vae_decode(z), group)
    sample = wavelet_reconstruction((sample + 1) / 2, gather(cond_img, group))
    return (sample * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
