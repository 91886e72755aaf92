"""SD2.1 UNet + IRControlNet, NCHW torch modules.

Counterpart of ``diffbir_tpu/models/unet.py``: the
ADM-style UNet (model_channels 320, mult (1,2,4,4), SpatialTransformer at
ds 4/2/1, 64-wide heads, linear transformer projections, context 1024) and
the ControlNet copy of its encoder with the hint concatenated at the input
conv and 13 zero-conv residuals. Control residuals are a tuple argument.
Attribute names equal the DiffBIR checkpoint keys. The UNet's forward has
the JAX phases: "full", "encode" (the input and middle blocks only: the
middle block's output before the control residual, and the skips) and
"decode" (the rest, from such a ``cached`` pair: encoder propagation
across timesteps, arXiv:2312.09608, for the turbo control cache).

``GEGLU.approximate``: "none" (exact erf, the reference) or "tanh" (the
CLI's ``--fast_gelu``, set by ``ControlLDM.set_serving``; the JAX package
reads ``DIFFBIR_TPU_FAST_GELU`` at trace time instead). The fused FFN (K7)
keeps the exact erf either way, as the JAX fused kernel does.

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

Hoisted inputs (the JAX "hoisted" collection): ``hoisted`` maps a module to
a value computed once before the denoise loop (``cldm.HoistTables``): a
cross-attention module to its context's k/v ([B, 77, 2 inner], one product
over ``cat(to_k, to_v)``), a ResBlock to its timestep projection for the
step ([1, Cout] or [B, Cout], broadcast over the batch). With rows for every
ResBlock the time embedding is not computed at all.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.fused_ffn import fused_ffn
from ..ops.fused_resblock import fused_resblock, tap_major
from ..ops.quant_matmul import quant_matmul
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
        # the float weights' HWIO copies for K6's tensor-core entry, by conv:
        # (the weight's version, device and address; the copy)
        self._tap_major = {}

    def _tap_major_of(self, suffix: str, w: torch.Tensor) -> torch.Tensor:
        key = (w._version, w.device, w.data_ptr())
        hit = self._tap_major.get(suffix)
        if hit is None or hit[0] != key:
            hit = self._tap_major[suffix] = (key, tap_major(w))
        return hit[1]

    def fused_params(self) -> dict:
        """K6's parameter dict (``ops.fused_resblock``): the module's own
        tensors, by reference; for bf16 float weights on a card also their
        HWIO copies (w1_t, ...), made once per weight version and kept (the
        tensor-core entry's B layout: as much memory again as the convs'
        weights)."""
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
                if c.weight.is_cuda and c.weight.dtype == torch.bfloat16:
                    p[f"w{suffix}_t"] = self._tap_major_of(suffix, c.weight)
            p[f"b{suffix}"] = c.bias
        return p

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor],
                emb_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``emb_out``: the hoisted ``emb_layers(emb)`` of this step, [1, Cout]
        or [B, Cout] (then ``emb`` is not read)."""
        e = self.emb_layers(emb) if emb_out is None else emb_out.expand(x.shape[0], -1)
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

    def context_kv(self, context: torch.Tensor) -> torch.Tensor:
        """k and v of a context, [B, S, 2 inner]: one product over
        ``cat(to_k, to_v)`` (int8: the concatenated ``weight_q`` and scales,
        through K4), as the JAX ``_fused_proj`` computes them in the loop and
        ``hoist_context_kv`` before it."""
        if isinstance(self.to_k, QuantLinear):
            w = torch.cat([self.to_k.weight_q, self.to_v.weight_q], dim=1)
            s = torch.cat([self.to_k.weight_scale, self.to_v.weight_scale])
            return quant_matmul(context.to(self.to_k.dtype), w, s)
        w = torch.cat([self.to_k.weight, self.to_v.weight])
        return F.linear(context.to(w.dtype), w)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention when ``context`` and ``kv`` are None; else attention
        to the context, whose k/v (``context_kv``) may come hoisted as
        ``kv``."""
        b, sq, _ = x.shape
        q = self.to_q(x)
        if context is None and kv is None:
            k, v = self.to_k(x), self.to_v(x)
        else:
            kv = self.context_kv(context) if kv is None else kv
            k, v = kv.chunk(2, dim=-1)
        skv = k.shape[1]
        q = q.reshape(b, sq, self.heads, self.dim_head)
        k = k.reshape(b, skv, self.heads, self.dim_head)
        v = v.reshape(b, skv, self.heads, self.dim_head)
        out = attention(q, k, v, impl=self.attn_impl, layout=self.flash_layout)
        return self.to_out(out.reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype, device=None, quant: bool = False):
        super().__init__()
        self.proj = _dense(dim, inner * 2, quant, dtype=dtype, device=device)
        self.approximate = "none"  # exact erf GELU; "tanh" under --fast_gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate=self.approximate)


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

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, kv)
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

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                hoisted: Optional[Mapping[nn.Module, torch.Tensor]] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        seq = self.norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        seq = self.proj_in(seq)
        for block in self.transformer_blocks:
            seq = block(seq, context, None if hoisted is None else hoisted.get(block.attn2))
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

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor], context: torch.Tensor,
                hoisted: Optional[Mapping[nn.Module, torch.Tensor]] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = self._run(layer, x, emb, None if hoisted is None else hoisted.get(layer))
            elif isinstance(layer, SpatialTransformer):
                x = self._run(layer, x, context, hoisted)
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

    def _embed_unless_hoisted(self, timesteps: torch.Tensor,
                              hoisted: Optional[Mapping[nn.Module, torch.Tensor]]):
        """The time embedding, or None where ``hoisted`` holds the rows of
        every ResBlock (the tables hold all or none; the middle block's first
        ResBlock stands for them)."""
        if hoisted is not None and self.middle_block[0] in hoisted:
            return None
        return self.embed(timesteps)


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

    def forward(self, x: Optional[torch.Tensor], timesteps: torch.Tensor, context: torch.Tensor,
                control: Optional[Tuple[torch.Tensor, ...]] = None,
                hoisted: Optional[Mapping[nn.Module, torch.Tensor]] = None,
                phase: str = "full",
                cached: Optional[Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]] = None):
        """``phase``: "full" (the output), "encode" (``(h_mid, skips)``, before
        the control residual is added) or "decode" (the output from
        ``cached`` = such a pair; ``x`` is not read)."""
        if phase not in ("full", "encode", "decode"):
            raise ValueError(f"unknown phase {phase!r}")
        emb = self._embed_unless_hoisted(timesteps, hoisted)
        context = context.to(self.dtype)
        if phase == "decode":
            if cached is None:
                raise ValueError('phase="decode" needs cached=(h_mid, skips)')
            h, hs = cached[0], list(cached[1])
        else:
            h = x.to(self.dtype)
            hs = []
            for block in self.input_blocks:
                h = block(h, emb, context, hoisted)
                hs.append(h)
            h = self.middle_block(h, emb, context, hoisted)
            if phase == "encode":
                return h, tuple(hs)
        if control is not None:
            h = h + control[-1].to(h.dtype)
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control[len(hs)].to(skip.dtype)
            h = block(torch.cat([h, skip], dim=1), emb, context, hoisted)
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
                context: torch.Tensor,
                hoisted: Optional[Mapping[nn.Module, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, ...]:
        emb = self._embed_unless_hoisted(timesteps, hoisted)
        context = context.to(self.dtype)
        h = torch.cat([x, hint], dim=1).to(self.dtype)
        outs = []
        for block, zero_conv in zip(self.input_blocks, self.zero_convs):
            h = block(h, emb, context, hoisted)
            outs.append(zero_conv(h))
        h = self.middle_block(h, emb, context, hoisted)
        outs.append(self.middle_block_out(h))
        return tuple(outs)
