"""ParseNet face-parsing network (19 classes).

Counterpart of ``diffbir_tpu/models/parsenet.py`` (facexlib's ParseNet):
reflection-padded convs with frozen BatchNorm and LeakyReLU 0.2, a
down / residual / up hourglass from ``in_size`` to ``min_feat_size`` and
back with channels clipped to ``ch_range``, and two heads (parsing logits,
image). Attribute names are facexlib's ``parsing_parsenet.pth`` keys
(``encoder.1.conv1.norm.norm.weight``, ...), so the published checkpoint
loads strictly. NHWC in and out, NCHW inside, fp32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import nearest_upsample_2x
from .retinaface import FrozenBN


class _Norm(nn.Module):
    """facexlib's NormLayer: the BatchNorm sits one level down (``norm.norm``)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.norm = FrozenBN(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class ConvLayer(nn.Module):
    """[2x nearest up] -> reflect pad -> conv (stride 2 for "down") ->
    [BatchNorm] -> [LeakyReLU 0.2]; the conv has a bias only without the
    norm (facexlib's ``ConvLayer``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, scale: str = "none",
                 norm: bool = False, relu: bool = False, device=None):
        super().__init__()
        self.scale, self.relu, self.pad = scale, relu, kernel // 2
        self.conv2d = nn.Conv2d(c_in, c_out, kernel, 2 if scale == "down" else 1,
                                bias=not norm, device=device)
        self.norm = _Norm(c_out, device) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == "up":
            x = nearest_upsample_2x(x)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.conv2d(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, 0.2) if self.relu else x


class ResidualBlock(nn.Module):
    """conv1 (scale phase A) -> conv2 (scale phase B) + shortcut (identity
    where the shape stays, else a biased ConvLayer)."""

    def __init__(self, c_in: int, c_out: int, scale: str = "none", device=None):
        super().__init__()
        first, second = {"none": ("none", "none"), "down": ("none", "down"),
                         "up": ("up", "none")}[scale]
        self.shortcut_func = None if c_in == c_out and scale == "none" else ConvLayer(
            c_in, c_out, 3, scale, device=device)
        self.conv1 = ConvLayer(c_in, c_out, 3, first, norm=True, relu=True, device=device)
        self.conv2 = ConvLayer(c_out, c_out, 3, second, norm=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        return identity + self.conv2(self.conv1(x))


class ParseNet(nn.Module):
    def __init__(self, in_size: int = 512, out_size: int = 512, min_feat_size: int = 32,
                 base_ch: int = 64, parsing_ch: int = 19, res_depth: int = 10,
                 ch_range: Tuple[int, int] = (32, 256), device=None):
        super().__init__()
        lo, hi = ch_range
        clip = lambda c: max(lo, min(c, hi))  # noqa: E731
        min_feat = min(in_size, min_feat_size)
        down_steps = int(math.log2(in_size // min_feat))
        up_steps = int(math.log2(out_size // min_feat))
        # encoder.0 is facexlib's ConvLayer(3, base_ch, 3, 1): a bare biased conv
        enc = [ConvLayer(3, base_ch, 3, device=device)]
        head_ch = base_ch
        for _ in range(down_steps):
            enc.append(ResidualBlock(clip(head_ch), clip(head_ch * 2), "down", device))
            head_ch *= 2
        self.encoder = nn.Sequential(*enc)
        self.body = nn.Sequential(*(ResidualBlock(clip(head_ch), clip(head_ch), device=device)
                                    for _ in range(res_depth)))
        dec = []
        for _ in range(up_steps):
            dec.append(ResidualBlock(clip(head_ch), clip(head_ch // 2), "up", device))
            head_ch //= 2
        self.decoder = nn.Sequential(*dec)
        self.out_img_conv = ConvLayer(clip(head_ch), 3, 3, device=device)
        self.out_mask_conv = ConvLayer(clip(head_ch), parsing_ch, 3, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NHWC in [-1, 1]. Returns (parsing logits [N, H, W, 19], image
        [N, H, W, 3])."""
        feat = self.encoder(x.permute(0, 3, 1, 2))
        h = self.decoder(self.body(feat) + feat)
        return (self.out_mask_conv(h).permute(0, 2, 3, 1),
                self.out_img_conv(h).permute(0, 2, 3, 1))


class FaceParser:
    """``parse(face_rgb01)``: an [H, W, 3] RGB image in [0, 1] (numpy or
    tensor) -> the int32 [H, W] class map on the network's device, through
    [-1, 1] and the logits' argmax (the JAX ``FaceParser``)."""

    def __init__(self, model: ParseNet):
        self.model = model.eval()

    @torch.no_grad()
    def parse(self, face_rgb01) -> torch.Tensor:
        device = next(self.model.parameters()).device
        x = torch.as_tensor(face_rgb01, dtype=torch.float32, device=device)
        logits = self.model(x[None] * 2.0 - 1.0)[0]
        return logits[0].argmax(dim=-1).to(torch.int32)
