"""SD2.1 UNet + IRControlNet, NCHW torch modules.

Counterpart of ``diffbir_tpu/models/unet.py`` (full-mode forward only): the
ADM-style UNet (model_channels 320, mult (1,2,4,4), SpatialTransformer at
ds 4/2/1, 64-wide heads, linear transformer projections, context 1024) and
the ControlNet copy of its encoder with the hint concatenated at the input
conv and 13 zero-conv residuals. Control residuals are a tuple argument.
Attribute names equal the DiffBIR checkpoint keys.

``use_checkpoint`` recomputes every ResBlock and SpatialTransformer in the
backward instead of keeping its activations (the JAX package's ``nn.remat``
around the same two modules), through non-reentrant
``torch.utils.checkpoint``; it only acts while autograd records.

The JAX package's opt-in serving modes, with the same parameter names in
every mode (so one state dict loads into the unfused and the fused model):

- ``fused_resblock``: every ResBlock is one K6 call (``ops.fused_resblock``);
- ``quant_conv`` (needs ``fused_resblock``): its convs are int8 ``QuantConv``
  holders read by K6;
- ``quant_dense``: ``to_q``/``to_k``/``to_v``/``to_out.0``, the GEGLU
  ``proj``, ``net.2``, ``proj_in``, ``proj_out`` and ``emb_layers.1`` are
  ``QuantLinear`` (K4), the JAX ``_QUANT_DENSE_TAILS``;
- ``fused_ffn``: every transformer FFN is one K7 call (``ops.fused_ffn``),
  float mode only, as in JAX;
- ``CrossAttention.flash_layout``: "folded" (K1) or "packed" (K3), set per
  module as ``attn_impl`` is.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.fused_ffn import fused_ffn
from ..ops.fused_resblock import fused_resblock
from .layers import (
    GroupNorm32,
    LayerNormFp32,
    QuantConv,
    QuantLinear,
    conv,
    dense,
    nearest_upsample_2x,
    timestep_embedding,
)


def _dense(in_dim: int, out_dim: int, quant: bool, bias: bool = True, **kw) -> nn.Module:
    """A float Linear, or its int8 ``QuantLinear`` serving twin."""
    return (QuantLinear if quant else dense)(in_dim, out_dim, bias=bias, **kw)


class ResBlock(nn.Module):
    """GN32 -> SiLU -> conv3x3 -> +temb -> GN32 -> SiLU -> conv3x3, skip;
    with ``fused`` one K6 call, with ``quant_conv`` (needs ``fused``) on int8
    conv weights, with ``quant_dense`` an int8 ``emb_layers.1``."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dtype, device=None,
                 quant_dense: bool = False, fused: bool = False, quant_conv: bool = False):
        super().__init__()
        if quant_conv and not fused:
            raise ValueError("quant_conv requires the fused ResBlock path")
        kw = dict(dtype=dtype, device=device)
        cv = (lambda i, o, k: QuantConv(i, o, k, **kw)) if quant_conv else (
            lambda i, o, k: conv(i, o, k, padding=k // 2, **kw))
        self.dtype, self.fused, self.quant_conv = dtype, fused, quant_conv
        self.in_layers = nn.Sequential(
            GroupNorm32(in_ch, device=device), nn.SiLU(), cv(in_ch, out_ch, 3))
        self.emb_layers = nn.Sequential(nn.SiLU(), _dense(emb_dim, out_ch, quant_dense, **kw))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, device=device), nn.SiLU(), nn.Identity(), cv(out_ch, out_ch, 3))
        self.skip_connection = cv(in_ch, out_ch, 1) if in_ch != out_ch else nn.Identity()

    def fused_params(self) -> dict:
        """K6's parameter dict (``ops.fused_resblock``): the module's own
        tensors, by reference."""
        gn1, gn2 = self.in_layers[0], self.out_layers[0]
        p = dict(gn1_scale=gn1.weight, gn1_bias=gn1.bias, gn2_scale=gn2.weight,
                 gn2_bias=gn2.bias)
        convs = [("1", self.in_layers[2]), ("2", self.out_layers[3])]
        if not isinstance(self.skip_connection, nn.Identity):
            convs.append(("_skip", self.skip_connection))
        for suffix, c in convs:
            if self.quant_conv:
                p[f"w{suffix}_q"], p[f"s{suffix}"] = c.weight_q, c.weight_scale
            else:
                p[f"w{suffix}"] = c.weight
            p[f"b{suffix}"] = c.bias
        return p

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        e = self.emb_layers(emb)
        if self.fused:
            return fused_resblock(x.to(self.dtype), e, self.fused_params())
        h = self.in_layers(x)
        h = h + e[:, :, None, None].to(h.dtype)
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype, device=None, quant: bool = False):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.heads, self.dim_head = heads, dim_head
        self.to_q = _dense(query_dim, inner, quant, bias=False, **kw)
        self.to_k = _dense(context_dim, inner, quant, bias=False, **kw)
        self.to_v = _dense(context_dim, inner, quant, bias=False, **kw)
        self.to_out = nn.Sequential(_dense(inner, query_dim, quant, **kw), nn.Identity())
        self.attn_impl = "auto"
        self.flash_layout = "folded"

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        skv = ctx.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, skv, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, skv, self.heads, self.dim_head)
        out = attention(q, k, v, impl=self.attn_impl, layout=self.flash_layout)
        return self.to_out(out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype, device=None, quant: bool = False):
        super().__init__()
        self.proj = _dense(dim, inner * 2, quant, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU


class FeedForward(nn.Module):
    """GEGLU MLP; with ``fused`` one K7 call, which the int8 mode turns off,
    as the JAX FeedForward does (``enabled() and not self.quant``)."""

    def __init__(self, dim: int, dtype, mult: int = 4, device=None, quant: bool = False,
                 fused: bool = False):
        super().__init__()
        inner = dim * mult
        self.fused = fused and not quant
        self.net = nn.Sequential(
            GEGLU(dim, inner, dtype, device, quant), nn.Identity(),
            _dense(inner, dim, quant, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self.net(x)
        proj, down = self.net[0].proj, self.net[2]
        x2 = x.to(proj.weight.dtype).reshape(-1, x.shape[-1])
        out = fused_ffn(x2, proj.weight, proj.bias, down.weight, down.bias)
        return out.reshape(*x.shape[:-1], out.shape[-1])


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype, device=None, quant: bool = False, fused_ffn: bool = False):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype, device, quant)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype, device, quant)
        self.ff = FeedForward(dim, dtype, device=device, quant=quant, fused=fused_ffn)
        self.norm1 = LayerNormFp32(dim, device=device)
        self.norm2 = LayerNormFp32(dim, device=device)
        self.norm3 = LayerNormFp32(dim, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN -> linear proj_in -> transformer blocks -> linear proj_out, + x."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 dtype, depth: int = 1, device=None, quant: bool = False,
                 fused_ffn: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6, device=device)
        self.proj_in = _dense(channels, inner, quant, dtype=dtype, device=device)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, dtype, device, quant,
                                  fused_ffn)
            for _ in range(depth))
        self.proj_out = _dense(inner, channels, quant, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        seq = self.norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        seq = self.proj_in(seq)
        for block in self.transformer_blocks:
            seq = block(seq, context)
        seq = self.proj_out(seq)
        return seq.transpose(1, 2).reshape(b, c, h, w) + x


class Downsample(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.op = conv(ch, ch, 3, stride=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = conv(ch, ch, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class EmbedSequential(nn.ModuleList):
    """One UNet block: ResBlocks take the timestep embedding, transformers
    the context, everything else the features alone. With ``use_checkpoint``
    the ResBlocks and transformers are recomputed in the backward."""

    def __init__(self, layers, use_checkpoint: bool = False):
        super().__init__(layers)
        self.use_checkpoint = use_checkpoint

    def _run(self, layer: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = self._run(layer, x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = self._run(layer, x, context)
            else:
                x = layer(x)
        return x


class _Encoder(nn.Module):
    """time_embed + input_blocks + middle_block, shared by UNet and ControlNet."""

    def __init__(self, in_channels: int, model_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], channel_mult: Sequence[int],
                 num_head_channels: int, transformer_depth: int, context_dim: int,
                 dtype, use_checkpoint: bool = False, device=None, modes: dict = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        mc, ted = model_channels, model_channels * 4
        self.dtype = dtype
        self.model_channels = mc
        self.time_embed = nn.Sequential(dense(mc, ted, **kw), nn.SiLU(), dense(ted, ted, **kw))
        modes = modes or {}
        # how _res() and _st() build the blocks (construction only)
        self._res_kw = dict(emb_dim=ted, dtype=dtype, device=device,
                            quant_dense=modes.get("quant_dense", False),
                            fused=modes.get("fused_resblock", False),
                            quant_conv=modes.get("quant_conv", False))
        self._st_kw = dict(dim_head=num_head_channels, context_dim=context_dim, dtype=dtype,
                           depth=transformer_depth, device=device,
                           quant=modes.get("quant_dense", False),
                           fused_ffn=modes.get("fused_ffn", False))
        st = self._st

        self.input_blocks = nn.ModuleList([EmbedSequential([conv(in_channels, mc, 3, **kw)])])
        self.block_channels = [mc]  # channels of each input block's output
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [self._res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(EmbedSequential(layers, use_checkpoint))
                self.block_channels.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential([Downsample(ch, **kw)]))
                self.block_channels.append(ch)
                ds *= 2
        self.middle_block = EmbedSequential([self._res(ch, ch), st(ch), self._res(ch, ch)],
                                            use_checkpoint)
        self.ds = ds

    def _res(self, in_ch: int, out_ch: int) -> ResBlock:
        return ResBlock(in_ch, out_ch, **self._res_kw)

    def _st(self, ch: int) -> SpatialTransformer:
        return SpatialTransformer(ch, ch // self._st_kw["dim_head"], **self._st_kw)

    def embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(timestep_embedding(timesteps, self.model_channels)).to(self.dtype)


class UNetModel(_Encoder):
    """SD2.1 UNet with optional ControlNet residual injection: ``control`` is
    a tuple of 13 NCHW tensors (12 encoder block outputs + the middle)."""

    def __init__(self, in_channels: int = 4, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 transformer_depth: int = 1, context_dim: int = 1024,
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False,
                 device=None, **modes):
        super().__init__(in_channels, model_channels, num_res_blocks, attention_resolutions,
                         channel_mult, num_head_channels, transformer_depth, context_dim,
                         dtype, use_checkpoint, device, modes)
        mc = model_channels
        ch, ds = self.block_channels[-1], self.ds
        skips = list(self.block_channels)
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [self._res(ch + skips.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(self._st(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dtype, device))
                    ds //= 2
                self.output_blocks.append(EmbedSequential(layers, use_checkpoint))
        self.out = nn.Sequential(
            GroupNorm32(ch, device=device), nn.SiLU(),
            conv(ch, out_channels, 3, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                control: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
        emb = self.embed(timesteps)
        context = context.to(self.dtype)
        h = x.to(self.dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        if control is not None:
            h = h + control[-1].to(h.dtype)
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control[len(hs)].to(skip.dtype)
            h = block(torch.cat([h, skip], dim=1), emb, context)
        return self.out(h)  # out.2 is an fp32 conv


class ControlNet(_Encoder):
    """IRControlNet: UNet encoder + middle copy with the VAE-latent hint
    concatenated at the input conv and a zero-conv per block output."""

    def __init__(self, in_channels: int = 4, hint_channels: int = 4,
                 model_channels: int = 320, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 transformer_depth: int = 1, context_dim: int = 1024,
                 dtype: torch.dtype = torch.float32, use_checkpoint: bool = False,
                 device=None, **modes):
        super().__init__(in_channels + hint_channels, model_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_head_channels,
                         transformer_depth, context_dim, dtype, use_checkpoint, device, modes)
        kw = dict(dtype=dtype, device=device)
        self.zero_convs = nn.ModuleList(
            nn.Sequential(conv(c, c, 1, padding=0, **kw)) for c in self.block_channels)
        ch = self.block_channels[-1]
        self.middle_block_out = nn.Sequential(conv(ch, ch, 1, padding=0, **kw))

    def forward(self, x: torch.Tensor, hint: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        emb = self.embed(timesteps)
        context = context.to(self.dtype)
        h = torch.cat([x, hint], dim=1).to(self.dtype)
        outs = []
        for block, zero_conv in zip(self.input_blocks, self.zero_convs):
            h = block(h, emb, context)
            outs.append(zero_conv(h))
        h = self.middle_block(h, emb, context)
        outs.append(self.middle_block_out(h))
        return tuple(outs)
