"""Classification Swin Transformer: RAM++'s swin-L image encoder.

Counterpart of ``diffbir_tpu/captioners/swin_cls.py``: patch embed (conv
k4 s4, then LayerNorm), four stages of shifted-window blocks (the port's
SwinIR ``SwinBlock``, whose key names these are too) with a
``PatchMerging`` after each stage but the last, a final LayerNorm, and the
mean token prepended to the patch tokens. At 384x384 with window 12 the
stages are 96, 48, 24 and 12 tokens wide; the last equals the window, so
its blocks take no shift, as in JAX.

Images enter NHWC; the convolution runs NCHW, the blocks on [B, L, C]
tokens, in the weights' dtype with fp32 LayerNorm statistics.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..models.layers import LayerNormFp32, conv, dense
from ..models.swinir import SwinBlock


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (x0, x1, x2, x3 as in JAX), LayerNorm,
    then a bias-free reduction to twice the width."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.norm = LayerNormFp32(4 * dim, device=device)
        self.reduction = dense(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, l, c = x.shape
        img = x.reshape(b, h, w, c)
        merged = torch.cat([img[:, 0::2, 0::2], img[:, 1::2, 0::2], img[:, 0::2, 1::2],
                            img[:, 1::2, 1::2]], dim=-1).reshape(b, l // 4, 4 * c)
        return self.reduction(self.norm(merged))


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class SwinClassifier(nn.Module):
    """[B, H, W, 3] -> [B, 1 + L, C]: the mean token, then the final patch
    tokens."""

    def __init__(self, img_size: int = 384, patch_size: int = 4, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2), num_heads: Sequence[int] = (6, 12, 24, 48),
                 window_size: int = 12, mlp_ratio: float = 4.0, dtype=torch.float32,
                 device=None):
        """``img_size`` is unused (shapes come from the input), as in JAX."""
        super().__init__()
        self.patch_size = patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = conv(3, embed_dim, patch_size, stride=patch_size, padding=0,
                                     dtype=dtype, device=device)
        self.patch_embed.norm = LayerNormFp32(embed_dim, device=device)
        stages, dim = [], embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = [SwinBlock(dim, heads, window_size, 0 if j % 2 == 0 else window_size // 2,
                                mlp_ratio, dtype, device) for j in range(depth)]
            last = i == len(depths) - 1
            stages.append(_Stage(blocks, None if last else PatchMerging(dim, dtype, device)))
            dim = dim if last else 2 * dim
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNormFp32(dim, device=device)
        self.num_features = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.patch_embed.proj
        x = proj(x.permute(0, 3, 1, 2).to(proj.weight.dtype))
        b, c, h, w = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        for stage in self.layers:
            for blk in stage.blocks:
                x = blk(x, (h, w))
            if hasattr(stage, "downsample"):
                x = stage.downsample(x, (h, w))
                h, w = h // 2, w // 2
        x = self.norm(x)
        return torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
