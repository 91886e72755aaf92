"""SCUNet: the Swin-Conv UNet blind denoiser (DiffBIR v2's denoise cleaner).

Counterpart of ``diffbir_tpu/models/scunet.py``: a 4-level UNet whose
blocks run a conv branch and a (shifted-)window transformer branch side by
side (``ConvTransBlock``), k2s2 convolutions down and k2s2 transposed
convolutions up, the input edge-padded to a multiple of 64 and the output
cropped back. The image enters and leaves NHWC in [0, 1] (not clipped);
convolutions run NCHW in the weights' dtype, the transformer on [B, H, W, C]
tokens, ``m_tail`` in fp32.

Window attention is plain torch math (``ops.attention.plain_attention``) with
the learnt relative-position bias, as it is XLA in JAX; the shifted windows
take SwinIR's additive mask (``models.swinir.shift_attn_mask``, -100 where
the reference masks with -inf: after the softmax the two agree to fp32).
Attribute names are the KAIR checkpoint's keys
(``m_down1.0.trans_block.msa.relative_position_params``, ...), so
``scunet_color_real_psnr.pth`` loads strictly.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import plain_attention
from .layers import Conv2d, ConvTranspose2d, LayerNormFp32, conv, dense
from .swinir import Band, roll_hw, window_mask, window_partition, window_reverse


@functools.lru_cache(maxsize=16)
def relative_indices(window: int) -> np.ndarray:
    """(N, N, 2) row and column indices into the (2w-1, 2w-1) bias table."""
    cord = np.array([[i, j] for i in range(window) for j in range(window)])
    return cord[:, None, :] - cord[None, :, :] + window - 1


class WMSA(nn.Module):
    """(Shifted-)window multi-head self-attention with a relative bias."""

    def __init__(self, dim: int, head_dim: int, window: int, shifted: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.head_dim = dim // head_dim, head_dim
        self.window, self.shifted = window, shifted
        self.relative_position_params = nn.Parameter(
            torch.zeros(self.heads, 2 * window - 1, 2 * window - 1, device=device))
        self.embedding_layer = dense(dim, 3 * dim, dtype=dtype, device=device)
        self.linear = dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, band: Optional[Band] = None) -> torch.Tensor:
        """x: (B, H, W, C) -> (B, H, W, C); H is ``band``'s rows where one
        is given (``models.swinir.Band``)."""
        b, h, w, c = x.shape
        p, heads = self.window, self.heads
        if self.shifted:
            x = roll_hw(x, -(p // 2), band)
        q, k, v = (t.reshape(-1, p * p, heads, self.head_dim)
                   for t in self.embedding_layer(window_partition(x, p)).chunk(3, dim=-1))
        rel = torch.as_tensor(relative_indices(p), device=x.device)
        bias = self.relative_position_params[:, rel[..., 0], rel[..., 1]][None]
        if self.shifted:
            m = torch.as_tensor(window_mask(h, w, p, p // 2, band), device=x.device)
            bias = bias + m.repeat(q.shape[0] // m.shape[0], 1, 1)[:, None]
        out = plain_attention(q, k, v, bias=bias).reshape(-1, p * p, c)
        out = window_reverse(self.linear(out), p, h, w)
        if self.shifted:
            out = roll_hw(out, p // 2, band)
        return out


class TransBlock(nn.Module):
    def __init__(self, dim: int, head_dim: int, window: int, shifted: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.ln1 = LayerNormFp32(dim, device=device)
        self.msa = WMSA(dim, head_dim, window, shifted, dtype, device)
        self.ln2 = LayerNormFp32(dim, device=device)
        self.mlp = nn.Sequential(dense(dim, 4 * dim, dtype=dtype, device=device), nn.GELU(),
                                 dense(4 * dim, dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.msa(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ConvTransBlock(nn.Module):
    """A 1x1 conv split into a residual conv branch and a transformer
    branch, joined by a 1x1 conv, plus the block's input. NCHW."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int, window: int,
                 shifted: bool, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        total = conv_dim + trans_dim
        self.conv_dim = conv_dim
        self.conv1_1 = conv(total, total, 1, **kw)
        self.conv_block = nn.Sequential(
            Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False, **kw), nn.ReLU(),
            Conv2d(conv_dim, conv_dim, 3, padding=1, bias=False, **kw))
        self.trans_block = TransBlock(trans_dim, head_dim, window, shifted, dtype, device)
        self.conv1_2 = conv(total, total, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv_x, trans_x = self.conv1_1(x).split(
            [self.conv_dim, x.shape[1] - self.conv_dim], dim=1)
        conv_x = conv_x + self.conv_block(conv_x)
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + self.conv1_2(torch.cat([conv_x, trans_x], dim=1))


class SCUNet(nn.Module):
    """The denoiser: [0, 1] RGB NHWC in, NHWC fp32 of the same size out.
    ``config``: ConvTransBlocks per stage (down 1-3, body, up 3-1)."""

    def __init__(self, in_nc: int = 3, config: Sequence[int] = (4,) * 7, dim: int = 64,
                 head_dim: int = 32, window: int = 8, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype

        def blocks(n, width):
            # windows alternate plain and shifted from each stage's first block
            return [ConvTransBlock(width // 2, width // 2, head_dim, window, bool(i % 2),
                                   dtype, device) for i in range(n)]

        def down(width):
            return Conv2d(width, 2 * width, 2, stride=2, padding=0, bias=False, **kw)

        def up(width):
            return ConvTranspose2d(2 * width, width, 2, stride=2, bias=False, **kw)

        d = dim
        self.m_head = nn.Sequential(Conv2d(in_nc, d, 3, padding=1, bias=False, **kw))
        self.m_down1 = nn.Sequential(*blocks(config[0], d), down(d))
        self.m_down2 = nn.Sequential(*blocks(config[1], 2 * d), down(2 * d))
        self.m_down3 = nn.Sequential(*blocks(config[2], 4 * d), down(4 * d))
        self.m_body = nn.Sequential(*blocks(config[3], 8 * d))
        self.m_up3 = nn.Sequential(up(4 * d), *blocks(config[4], 4 * d))
        self.m_up2 = nn.Sequential(up(2 * d), *blocks(config[5], 2 * d))
        self.m_up1 = nn.Sequential(up(d), *blocks(config[6], d))
        self.m_tail = nn.Sequential(Conv2d(d, in_nc, 3, padding=1, bias=False,
                                           dtype=torch.float32, device=device))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x0.shape
        x = x0.permute(0, 3, 1, 2)
        ph, pw = (-h) % 64, (-w) % 64
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="replicate")
        x1 = self.m_head(x.to(self.dtype))
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        y = self.m_up3(self.m_body(x4) + x4)
        y = self.m_up2(y + x3)
        y = self.m_up1(y + x2)
        out = self.m_tail((y + x1).float())
        return out[:, :, :h, :w].permute(0, 2, 3, 1)
