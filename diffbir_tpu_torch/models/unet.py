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
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from .layers import (
    GroupNorm32,
    LayerNormFp32,
    conv,
    dense,
    nearest_upsample_2x,
    timestep_embedding,
)


class ResBlock(nn.Module):
    """GN32 -> SiLU -> conv3x3 -> +temb -> GN32 -> SiLU -> conv3x3, skip."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_layers = nn.Sequential(
            GroupNorm32(in_ch, device=device), nn.SiLU(), conv(in_ch, out_ch, 3, **kw))
        self.emb_layers = nn.Sequential(nn.SiLU(), dense(emb_dim, out_ch, **kw))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, device=device), nn.SiLU(), nn.Identity(),
            conv(out_ch, out_ch, 3, **kw))
        self.skip_connection = (
            conv(in_ch, out_ch, 1, padding=0, **kw) if in_ch != out_ch else nn.Identity()
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 dtype, device=None):
        super().__init__()
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.heads, self.dim_head = heads, dim_head
        self.to_q = dense(query_dim, inner, bias=False, **kw)
        self.to_k = dense(context_dim, inner, bias=False, **kw)
        self.to_v = dense(context_dim, inner, bias=False, **kw)
        self.to_out = nn.Sequential(dense(inner, query_dim, **kw), nn.Identity())
        self.attn_impl = "auto"

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        skv = ctx.shape[1]
        q = self.to_q(x).reshape(b, sq, self.heads, self.dim_head)
        k = self.to_k(ctx).reshape(b, skv, self.heads, self.dim_head)
        v = self.to_v(ctx).reshape(b, skv, self.heads, self.dim_head)
        out = attention(q, k, v, impl=self.attn_impl)
        return self.to_out(out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype, device=None):
        super().__init__()
        self.proj = dense(dim, inner * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf GELU


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, mult: int = 4, device=None):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(
            GEGLU(dim, inner, dtype, device), nn.Identity(),
            dense(inner, dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype, device=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head, dtype, device)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, dtype, device)
        self.ff = FeedForward(dim, dtype, device=device)
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
                 dtype, depth: int = 1, device=None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6, device=device)
        self.proj_in = dense(channels, inner, dtype=dtype, device=device)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, dtype, device)
            for _ in range(depth))
        self.proj_out = dense(inner, channels, dtype=dtype, device=device)

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
                 dtype, use_checkpoint: bool = False, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        mc, ted = model_channels, model_channels * 4
        self.dtype = dtype
        self.model_channels = mc
        self.time_embed = nn.Sequential(dense(mc, ted, **kw), nn.SiLU(), dense(ted, ted, **kw))

        def st(ch):
            return SpatialTransformer(ch, ch // num_head_channels, num_head_channels,
                                      context_dim, dtype, transformer_depth, device)

        self.input_blocks = nn.ModuleList([EmbedSequential([conv(in_channels, mc, 3, **kw)])])
        self.block_channels = [mc]  # channels of each input block's output
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, ted, dtype, device)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(EmbedSequential(layers, use_checkpoint))
                self.block_channels.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential([Downsample(ch, **kw)]))
                self.block_channels.append(ch)
                ds *= 2
        self.middle_block = EmbedSequential([
            ResBlock(ch, ch, ted, dtype, device), st(ch), ResBlock(ch, ch, ted, dtype, device)],
            use_checkpoint)
        self.ds = ds

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
                 device=None):
        super().__init__(in_channels, model_channels, num_res_blocks, attention_resolutions,
                         channel_mult, num_head_channels, transformer_depth, context_dim,
                         dtype, use_checkpoint, device)
        mc, ted = model_channels, model_channels * 4
        ch, ds = self.block_channels[-1], self.ds
        skips = list(self.block_channels)
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), mc * mult, ted, dtype, device)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(SpatialTransformer(
                        ch, ch // num_head_channels, num_head_channels, context_dim,
                        dtype, transformer_depth, device))
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
                 device=None):
        super().__init__(in_channels + hint_channels, model_channels, num_res_blocks,
                         attention_resolutions, channel_mult, num_head_channels,
                         transformer_depth, context_dim, dtype, use_checkpoint, device)
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
