"""SwinIR restoration transformer (stage-1 cleaner).

Counterpart of ``diffbir_tpu/models/swinir.py``, realesrgan configuration:
embed 180, 8 RSTBs of depth 6, 6 heads, window 8, mlp_ratio 2, a x8 pixel
unshuffle at the input and the nearest+conv x8 upsampler, i.e. a x1 net on a
pre-upscaled input. The image enters and leaves NHWC in [0, 1]; convolutions
run NCHW, the transformer on [B, H, W, C] tokens. Window attention (relative
position bias plus the shifted-window mask) is plain torch math, as it is XLA
in JAX. ``conv_last`` runs in fp32.

A ``Band`` runs a shifted-window block on one H band of a spatially
sharded image (``parallel/inference.py``): the mask is the band's window
rows of the whole image's, and the H roll is the band's rows of the whole
image's roll (a cyclic exchange of rows across the bands).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import plain_attention
from ..utils.common import device_constant
from .layers import LayerNormFp32, conv, dense, nearest_upsample_2x

RGB_MEAN = (0.4488, 0.4371, 0.4040)
SCALE = 8  # pixel-unshuffle factor at the input = upsampling factor at the output


@functools.lru_cache(maxsize=64)
def relative_position_index(window: int) -> np.ndarray:
    """(N, N) indices into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (0 / -100) for shifted-window attention."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = (img.reshape(h // window, window, w // window, window)
           .transpose(0, 2, 1, 3).reshape(-1, window * window))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class Band(NamedTuple):
    """This process's H band of a spatially sharded image, in the rows of
    the tensor at hand: the whole image's height, the band's first row,
    and ``roll(y, shift)``, ``torch.roll`` of NHWC ``y`` by ``shift`` rows
    over the whole image, on this band."""

    image_h: int
    row0: int
    roll: Callable[[torch.Tensor, int], torch.Tensor]


def roll_hw(y: torch.Tensor, shift: int, band: Optional[Band] = None) -> torch.Tensor:
    """``torch.roll`` of NHWC ``y`` by ``shift`` along H and W (H across
    the bands of ``band``)."""
    y = torch.roll(y, shift, dims=2)
    return torch.roll(y, shift, dims=1) if band is None else band.roll(y, shift)


def window_mask(h: int, w: int, window: int, shift: int, band: Optional[Band] = None,
                device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """``shift_attn_mask`` of an h x w map, or of ``band``'s window rows of
    the whole image's, on ``device`` (``device_constant``: kept there)."""
    if band is None:
        return device_constant(shift_attn_mask, h, w, window, shift, device=device)
    per_row = w // window
    mask = device_constant(shift_attn_mask, band.image_h, w, window, shift, device=device)
    return mask[band.row0 // window * per_row: (band.row0 + h) // window * per_row]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(win: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, window*window, C) -> (B, H, W, C)."""
    b = win.shape[0] // (h * w // window // window)
    x = win.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, device=device))
        self.qkv = dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, window: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: (B*nW, N, C) with N = window^2; mask: (nW, N, N) or None."""
        bnw, n, c = x.shape
        heads = self.num_heads
        q, k, v = (t.reshape(bnw, n, heads, -1) for t in self.qkv(x).chunk(3, dim=-1))
        idx = device_constant(relative_position_index, window, device=x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            m = mask[:, None]  # (nW, 1, N, N)
            bias = bias + m.repeat(bnw // mask.shape[0], 1, 1, 1)
        out = plain_attention(q, k, v, bias=bias)
        return self.proj(out.reshape(bnw, n, -1))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float, dtype, device=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNormFp32(dim, device=device)
        self.attn = WindowAttention(dim, window, num_heads, dtype, device)
        self.norm2 = LayerNormFp32(dim, device=device)
        hid = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({
            "fc1": dense(dim, hid, dtype=dtype, device=device),
            "fc2": dense(hid, dim, dtype=dtype, device=device),
        })

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int],
                band: Optional[Band] = None) -> torch.Tensor:
        """x: (B, h*w, C) tokens of an h x w map, or of ``band``."""
        h, w = x_size
        b, l, c = x.shape
        window, shift = self.window, self.shift
        image_h = h if band is None else band.image_h
        if min(image_h, w) < window:
            # the JAX model builds a smaller bias table here; not ported
            raise NotImplementedError(f"feature map {image_h}x{w} smaller than window {window}")
        if min(image_h, w) == window:
            shift = 0
        y = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            y = roll_hw(y, -shift, band)
        mask = window_mask(h, w, window, shift, band, x.device) if shift > 0 else None
        y = window_reverse(self.attn(window_partition(y, window), window, mask), window, h, w)
        if shift > 0:
            y = roll_hw(y, shift, band)
        x = x + y.reshape(b, l, c)
        y = F.gelu(self.mlp["fc1"](self.norm2(x)))  # exact erf GELU
        return x + self.mlp["fc2"](y)


class _ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: blocks -> conv -> + residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: float, dtype, device=None):
        super().__init__()
        self.residual_group = _ResidualGroup(
            SwinBlock(dim, num_heads, window, 0 if j % 2 == 0 else window // 2,
                      mlp_ratio, dtype, device)
            for j in range(depth))
        self.conv = conv(dim, dim, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, x_size: Tuple[int, int]) -> torch.Tensor:
        h, w = x_size
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x, x_size)
        b, l, c = x.shape
        img = self.conv(x.transpose(1, 2).reshape(b, c, h, w))
        return img.flatten(2).transpose(1, 2) + res


class SwinIR(nn.Module):
    """The DiffBIR cleaner: [0, 1] RGB NHWC in, [0, 1]-range NHWC (fp32) out.
    Only the realesrgan head is ported: x8 pixel unshuffle, ``1conv``
    residual connection, ``nearest+conv`` x8 upsampler, img_range 1."""

    # the ported head: the constructor's other keywords (a train config's
    # ``model.swinir.params``) must take these values
    HEAD = dict(in_chans=3, sf=SCALE, img_range=1.0, upsampler="nearest+conv",
                resi_connection="1conv", unshuffle=True, unshuffle_scale=SCALE)

    def __init__(self, embed_dim: int = 180, depths: Sequence[int] = (6,) * 8,
                 num_heads: Sequence[int] = (6,) * 8, window_size: int = 8,
                 mlp_ratio: float = 2.0, dtype=torch.float32, device=None,
                 img_size: int = 64, drop_path_rate: float = 0.0, **head):
        """``img_size`` is unused (shapes come from the input), as in JAX;
        ``drop_path_rate`` is accepted and unused: JAX's trainers apply
        SwinIR with ``deterministic=True``, so no stochastic depth acts."""
        super().__init__()
        for name, value in head.items():
            if name not in self.HEAD:
                raise TypeError(f"SwinIR got an unexpected keyword {name!r}")
            if value != self.HEAD[name]:
                raise NotImplementedError(f"SwinIR {name}={value!r}: only the realesrgan head "
                                          f"({name}={self.HEAD[name]!r}) is ported")
        kw = dict(dtype=dtype, device=device)
        self.window_size = window_size
        self.dtype = dtype
        self.conv_first = nn.Sequential(
            nn.PixelUnshuffle(SCALE), conv(3 * SCALE**2, embed_dim, 3, **kw))
        self.patch_embed = nn.Module()
        self.patch_embed.norm = LayerNormFp32(embed_dim, device=device)
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, nh, window_size, mlp_ratio, dtype, device)
            for d, nh in zip(depths, num_heads))
        self.norm = LayerNormFp32(embed_dim, device=device)
        self.conv_after_body = conv(embed_dim, embed_dim, 3, **kw)
        self.conv_before_upsample = nn.Sequential(conv(embed_dim, 64, 3, **kw))
        self.conv_up1 = conv(64, 64, 3, **kw)
        self.conv_up2 = conv(64, 64, 3, **kw)
        self.conv_up3 = conv(64, 64, 3, **kw)
        self.conv_hr = conv(64, 64, 3, **kw)
        self.conv_last = conv(64, 3, 3, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h_in, w_in, _ = x.shape
        x = x.permute(0, 3, 1, 2)
        # pad so the unshuffled feature map tiles into windows; reflect needs
        # pad < dim, so tiny inputs replicate the edge instead
        mult = self.window_size * SCALE
        ph, pw = (-h_in) % mult, (-w_in) % mult
        if ph or pw:
            mode = "reflect" if ph < h_in and pw < w_in else "replicate"
            x = F.pad(x, (0, pw, 0, ph), mode=mode)
        mean = device_constant(np.asarray, RGB_MEAN, device=x.device, dtype=x.dtype)
        mean = mean.reshape(1, 3, 1, 1)
        x = (x - mean).to(self.dtype)

        feat = self.conv_first(x)
        bb, cc, hh, ww = feat.shape
        seq = self.patch_embed.norm(feat.flatten(2).transpose(1, 2))
        for layer in self.layers:
            seq = layer(seq, (hh, ww))
        deep = self.norm(seq).transpose(1, 2).reshape(bb, cc, hh, ww)
        feat = self.conv_after_body(deep) + feat

        lrelu = F.leaky_relu
        y = lrelu(self.conv_before_upsample(feat), 0.01)
        for up in (self.conv_up1, self.conv_up2, self.conv_up3):
            y = lrelu(up(nearest_upsample_2x(y)), 0.2)
        y = lrelu(self.conv_hr(y), 0.2)
        out = self.conv_last(y) + mean.float()
        return out[:, :, :h_in, :w_in].permute(0, 2, 3, 1)
