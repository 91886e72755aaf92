"""Shared NN layers for all diffbir_tpu_torch models (NCHW inside modules).

Counterpart of ``diffbir_tpu/models/layers.py``, with the same precision
policy: weights are built in the compute dtype (bf16 on the GPU) and every
layer casts its input to that dtype; GroupNorm and LayerNorm statistics are
fp32 and their output is in the input dtype; the timestep embedding is fp32.
Modules are named after the DiffBIR torch checkpoint keys, which are also the
flax param paths of the JAX package (see ``weights/convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant_matmul import QuantLinear  # noqa: F401  (the int8 dense layer)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32, [cos, sin] order."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def gn_fold_moments(
    s1: torch.Tensor, v_c: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    num_groups: int, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel fp32 mean ``s1`` and two-pass variance ``v_c`` [B, C] ->
    per-channel affine (a, b) with GroupNorm(x) = x*a + b. Folds to groups
    with var_g = mean_c(var_c + (mu_c - mu_g)^2)."""
    bsz, c = s1.shape
    cg = c // num_groups
    s1g = s1.reshape(bsz, num_groups, cg)
    m_g = s1g.mean(-1)
    dm = s1g - m_g[..., None]
    var_g = (v_c.reshape(bsz, num_groups, cg) + dm * dm).mean(-1)
    mean = m_g.repeat_interleave(cg, dim=-1)
    inv = torch.rsqrt(var_g + eps).repeat_interleave(cg, dim=-1)
    a = inv * scale
    return a, bias - mean * a


class GroupNorm32(nn.Module):
    """GroupNorm over NC... with fp32 two-pass statistics; the affine is
    applied in the input dtype. eps 1e-5 in the UNet, 1e-6 in the VAE and
    SpatialTransformer. ``cross_batch``: the statistics run over the batch
    axis too, as when the tiles of one image ride the batch axis (the
    seam-free tiled VAE); a switch, not a parameter."""

    num_groups = 32

    def __init__(self, channels: int, eps: float = 1e-5, device=None,
                 cross_batch: bool = False):
        super().__init__()
        if channels % self.num_groups:
            raise ValueError(f"channels {channels} not divisible by {self.num_groups} groups")
        self.eps = eps
        self.cross_batch = cross_batch
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        axes = ((0,) if self.cross_batch else ()) + tuple(range(2, x.dim()))
        s1 = xf.mean(dim=axes, keepdim=True)  # [B or 1, C, 1, ...]
        d = xf - s1
        v_c = (d * d).mean(dim=axes, keepdim=True)
        a, b = gn_fold_moments(s1.flatten(1), v_c.flatten(1), self.weight.float(),
                               self.bias.float(), self.num_groups, self.eps)
        return x * a.reshape(s1.shape).to(x.dtype) + b.reshape(s1.shape).to(x.dtype)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm with fp32 statistics and affine, output in the input dtype;
    the parameters are stored in ``dtype`` (fp32 by default)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
            self.eps,
        ).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv that runs in its weights' dtype (the input is cast to it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv that runs in its weights' dtype (weight (in, out, kh,
    kw), as torch and the KAIR checkpoints store it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class Linear(nn.Linear):
    """Linear that runs in its weights' dtype (the input is cast to it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


def conv(
    in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
    padding: Optional[int] = None, dtype: torch.dtype = torch.float32, device=None,
) -> Conv2d:
    """Conv with torch-style explicit symmetric padding (kernel // 2 default)."""
    if padding is None:
        padding = kernel // 2
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                  dtype=dtype, device=device)


def dense(in_dim: int, out_dim: int, bias: bool = True,
          dtype: torch.dtype = torch.float32, device=None) -> Linear:
    return Linear(in_dim, out_dim, bias=bias, dtype=dtype, device=device)


class QuantConv(nn.Module):
    """Holder of one int8 conv for the fused ResBlock's serving mode (the JAX
    ``_ConvParams(quant=True)`` scope): ``weight_q`` int8 in the JAX HWIO
    layout (kernel, kernel, in, out), ``weight_scale`` fp32 [out] (see
    ``ops.fused_resblock.quantize_conv_weight``) and ``bias`` in the model's
    dtype. It has no forward of its own: K6 reads it."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(kernel, kernel, in_ch, out_ch,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(out_ch, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, dtype=dtype, device=device),
                                 requires_grad=False)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator``: weights of rank >= 2 with
    N(0, 1/fan_in) (no layer is left at zero, so every path carries signal),
    1-D ``weight``s (norm scales) with ones, other 1-D params (biases) with
    zeros. Draws in fp32 on the generator's device, in parameter order."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            p.copy_(w * fan_in ** -0.5)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
