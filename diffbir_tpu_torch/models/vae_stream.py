"""Streaming tiled VAE with exact cross-tile GroupNorm.

Counterpart of ``diffbir_tpu/models/vae_stream.py`` (the reference's
task-queue tiled VAE): the tiles of one image ride a leading axis, and the
network runs layer by layer over all of them.

- Every GroupNorm reduces over all T tiles (and H, W) in fp32: per-channel
  sums taken chunk by chunk, then the two-pass variance the same way, folded
  to groups as ``GroupNorm32`` folds them; the affine is applied inside the
  next segment, per chunk, in the activation's dtype as ``GroupNorm32``
  applies it. So a seam-free tiled output equals ``Decoder(gn_cross=True)``
  (``Encoder(gn_cross=True)``) on the stacked tiles.
- Conv, attention and resample segments run over chunks of ``chunk`` tiles
  (a Python loop in place of the JAX ``lax.map``): the convolution workspace
  is bounded by a chunk, and only layer-boundary activations of all tiles
  are resident at once. A normalised activation of all tiles is never made.
  That is the module's reason: the gn_cross modules on the stacked tiles
  give the same output, but their GroupNorm holds fp32 copies of a whole
  layer, so they peak at 1.7 to 3 times the stream's memory
  (``chip_smoke.py`` reads both at 1024^2 and 2048^2).

The walk reads the port's ``AutoencoderKL`` modules (``models/vae.py``), so
the weights are the model's own. Tiles enter and leave NHWC, as in the JAX
package; the modules run NCHW inside. Everything runs under
``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from .layers import GroupNorm32, gn_fold_moments, nearest_upsample_2x
from .vae import AttnBlock, AutoencoderKL, ResnetBlock

Affine = Tuple[torch.Tensor, torch.Tensor]


def _map_chunks(fn: Callable[..., torch.Tensor], chunk: int, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over the leading (tile) axis of ``xs`` in chunks of ``chunk``
    tiles, the results written into one tensor (the last chunk runs short)."""
    t = xs[0].shape[0]
    if t <= chunk:
        return fn(*xs)
    out = None
    for i in range(0, t, chunk):
        y = fn(*(x[i: i + chunk] for x in xs))
        if out is None:
            out = y.new_empty((t,) + tuple(y.shape[1:]))
        out[i: i + y.shape[0]] = y
    return out


def _gn_stats(norm: GroupNorm32, x: torch.Tensor, chunk: int) -> Affine:
    """fp32 per-channel affine (a, b) [1, C, 1, 1] of ``norm`` with
    statistics over (tiles, H, W) jointly, reduced chunk by chunk."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    axes = (0, 2, 3)
    s1 = sum(x[i: i + chunk].float().sum(dim=axes) for i in range(0, x.shape[0], chunk)) / n
    mu = s1[None, :, None, None]
    v_c = sum(((x[i: i + chunk].float() - mu) ** 2).sum(dim=axes)
              for i in range(0, x.shape[0], chunk)) / n
    a, b = gn_fold_moments(s1[None], v_c[None], norm.weight.float(), norm.bias.float(),
                           norm.num_groups, norm.eps)
    return a[:, :, None, None], b[:, :, None, None]


def _normed(v: torch.Tensor, ab: Affine) -> torch.Tensor:
    a, b = ab
    return v * a.to(v.dtype) + b.to(v.dtype)


def _resblock(blk: ResnetBlock, x: torch.Tensor, chunk: int) -> torch.Tensor:
    ab1 = _gn_stats(blk.norm1, x, chunk)
    h = _map_chunks(lambda v: blk.conv1(F.silu(_normed(v, ab1))), chunk, x)
    ab2 = _gn_stats(blk.norm2, h, chunk)
    shortcut = getattr(blk, "nin_shortcut", None)

    def out_seg(hv, xv):
        y = blk.conv2(F.silu(_normed(hv, ab2)))
        return (xv if shortcut is None else shortcut(xv)) + y

    return _map_chunks(out_seg, chunk, h, x)


def _attnblock(blk: AttnBlock, x: torch.Tensor, chunk: int) -> torch.Tensor:
    ab = _gn_stats(blk.norm, x, chunk)

    def seg(v):
        b, c, h, w = v.shape
        tok = _normed(v, ab).flatten(2).transpose(1, 2)  # [b, hw, c]
        q, k, val = (blk._tokens_linear(tok, m).reshape(b, h * w, 1, c)
                     for m in (blk.q, blk.k, blk.v))
        out = attention(q, k, val, impl=blk.attn_impl).reshape(b, h * w, c)
        out = blk._tokens_linear(out, blk.proj_out)
        return v + out.transpose(1, 2).reshape(b, c, h, w)

    return _map_chunks(seg, chunk, x)


def _mid(mid, x: torch.Tensor, chunk: int) -> torch.Tensor:
    x = _resblock(mid.block_1, x, chunk)
    x = _attnblock(mid.attn_1, x, chunk)
    return _resblock(mid.block_2, x, chunk)


def _out(norm: GroupNorm32, conv_out, x: torch.Tensor, chunk: int) -> torch.Tensor:
    ab = _gn_stats(norm, x, chunk)
    return _map_chunks(lambda v: conv_out(F.silu(_normed(v, ab))), chunk, x)


@torch.no_grad()
def decode_sync(vae: AutoencoderKL, z_tiles: torch.Tensor, chunk: int = 8) -> torch.Tensor:
    """The decoder over [T, h, w, zc] latent tiles (already divided by the
    scale factor) with GroupNorm statistics over all tiles; returns fp32
    [T, 8h, 8w, 3]."""
    d = vae.decoder
    x = z_tiles.permute(0, 3, 1, 2)
    x = _map_chunks(lambda v: d.conv_in(vae.post_quant_conv(v.float())), chunk, x)
    x = _mid(d.mid, x, chunk)
    for level in reversed(d.up):
        for blk in level.block:
            x = _resblock(blk, x, chunk)
        if level.resample_name is not None:
            up = level.upsample
            x = _map_chunks(lambda v: up.conv(nearest_upsample_2x(v)), chunk, x)
    return _out(d.norm_out, d.conv_out, x, chunk).permute(0, 2, 3, 1)


@torch.no_grad()
def encode_sync_moments(vae: AutoencoderKL, img_tiles: torch.Tensor,
                        chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder over [T, H, W, 3] image tiles (in [-1, 1]) with GroupNorm
    statistics over all tiles; returns fp32 (mean, logvar) [T, H/8, W/8,
    embed_dim], logvar clamped to [-30, 20]."""
    e = vae.encoder
    x = _map_chunks(e.conv_in, chunk, img_tiles.permute(0, 3, 1, 2))
    for level in e.down:
        for blk in level.block:
            x = _resblock(blk, x, chunk)
        if level.resample_name is not None:
            x = _map_chunks(level.downsample, chunk, x)
    x = _mid(e.mid, x, chunk)
    x = _map_chunks(vae.quant_conv, chunk, _out(e.norm_out, e.conv_out, x, chunk))
    mean, logvar = x.permute(0, 2, 3, 1).chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)
