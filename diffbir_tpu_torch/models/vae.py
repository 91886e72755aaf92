"""AutoencoderKL (SD f8 KL-VAE), NCHW torch modules, untiled.

Counterpart of ``diffbir_tpu/models/vae.py``: GN(32, eps 1e-6) ResnetBlocks,
the single-head mid attention (the d=512 site of the flash kernel), the
asymmetric-pad downsample and double_z moments. The encoder's and decoder's
``conv_out`` and the (post_)quant convs run in fp32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import GroupNorm32, conv, nearest_upsample_2x


def Norm(ch: int, device=None) -> GroupNorm32:
    return GroupNorm32(ch, eps=1e-6, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = Norm(in_ch, device)
        self.conv1 = conv(in_ch, out_ch, 3, **kw)
        self.norm2 = Norm(out_ch, device)
        self.conv2 = conv(out_ch, out_ch, 3, **kw)
        if in_ch != out_ch:
            self.nin_shortcut = conv(in_ch, out_ch, 1, padding=0, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W tokens, 1x1-conv projections
    (applied as linears on the token layout, the same math)."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = Norm(ch, device)
        self.q = conv(ch, ch, 1, padding=0, **kw)
        self.k = conv(ch, ch, 1, padding=0, **kw)
        self.v = conv(ch, ch, 1, padding=0, **kw)
        self.proj_out = conv(ch, ch, 1, padding=0, **kw)
        self.attn_impl = "auto"

    @staticmethod
    def _tokens_linear(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
        w = layer.weight
        return F.linear(x.to(w.dtype), w.reshape(w.shape[0], w.shape[1]), layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tok = self.norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        q, k, v = (self._tokens_linear(tok, m).reshape(b, h * w, 1, c)
                   for m in (self.q, self.k, self.v))
        out = attention(q, k, v, impl=self.attn_impl).reshape(b, h * w, c)
        out = self._tokens_linear(out, self.proj_out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    """Stride-2 conv after torch's asymmetric (0,1,0,1) pad."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = conv(ch, ch, 3, stride=2, padding=0, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = conv(ch, ch, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class _Level(nn.Module):
    """One resolution level: ``block.{j}`` ResnetBlocks, then an optional
    ``downsample`` / ``upsample``."""

    def __init__(self, in_ch: int, out_ch: int, n_blocks: int, resample, dtype, device=None):
        super().__init__()
        self.block = nn.ModuleList(
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch, dtype, device)
            for j in range(n_blocks))
        self.resample_name = None
        if resample is not None:
            self.resample_name = "downsample" if resample is Downsample else "upsample"
            setattr(self, self.resample_name, resample(out_ch, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            x = blk(x)
        if self.resample_name is not None:
            x = getattr(self, self.resample_name)(x)
        return x


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch, dtype, device)
        self.attn_1 = AttnBlock(ch, dtype, device)
        self.block_2 = ResnetBlock(ch, ch, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, in_ch: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        n = len(ch_mult)
        self.conv_in = conv(in_ch, ch, 3, dtype=dtype, device=device)
        chans = [ch] + [ch * m for m in ch_mult]
        self.down = nn.ModuleList(
            _Level(chans[i], chans[i + 1], num_res_blocks,
                   Downsample if i != n - 1 else None, dtype, device)
            for i in range(n))
        c = chans[-1]
        self.mid = _Mid(c, dtype, device)
        self.norm_out = Norm(c, device)
        self.conv_out = conv(c, 2 * z_channels, 3, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = F.silu(self.norm_out(self.mid(h)))
        return self.conv_out(h)


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        n = len(ch_mult)
        c = ch * ch_mult[-1]
        self.conv_in = conv(z_channels, c, 3, dtype=dtype, device=device)
        self.mid = _Mid(c, dtype, device)
        # built in execution order (top level first), stored by level index
        levels = {}
        for i in reversed(range(n)):
            levels[i] = _Level(c, ch * ch_mult[i], num_res_blocks + 1,
                               Upsample if i != 0 else None, dtype, device)
            c = ch * ch_mult[i]
        self.up = nn.ModuleList(levels[i] for i in range(n))
        self.norm_out = Norm(c, device)
        self.conv_out = conv(c, out_ch, 3, dtype=torch.float32, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """f8 KL VAE. ``encode_moments`` returns (mean, logvar)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, embed_dim: int = 4,
                 out_ch: int = 3, dtype=torch.float32, device=None):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels, dtype=dtype,
                               device=device)
        self.decoder = Decoder(ch, out_ch, ch_mult, num_res_blocks, z_channels,
                               dtype=dtype, device=device)
        self.quant_conv = conv(2 * z_channels, 2 * embed_dim, 1, padding=0,
                               dtype=torch.float32, device=device)
        self.post_quant_conv = conv(embed_dim, z_channels, 1, padding=0,
                                    dtype=torch.float32, device=device)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x in [-1, 1] NCHW -> (mean, logvar), logvar clamped to [-30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
