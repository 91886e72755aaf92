"""Plain PyTorch reference of the DiffBIR v2.1 networks, in float32.

SD2.1 UNet + IRControlNet, the f8 KL VAE, the OpenCLIP ViT-H text tower and
the realesrgan SwinIR cleaner, written from the published architectures
with every attention as explicit softmax(q k^T / sqrt(d)) v, every norm as
``F.group_norm`` / ``F.layer_norm``, and no kernel, cache, hoisting, tiling
or checkpointing. Modules carry the DiffBIR checkpoint's parameter names,
so one state dict of the benchmark's weights loads into this model and into
the program under test alike. Nothing here imports the program.

Images and latents enter and leave NHWC, the modules run NCHW.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

def attention(q, k, v, mask=None, bias=None):
    """q [B, Sq, H, D], k/v [B, Skv, H, D] -> [B, Sq, H, D]."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, k)
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm(nn.GroupNorm):
    def __init__(self, ch, eps=1e-5):
        super().__init__(32, ch, eps=eps)


def conv(i, o, k=3, stride=1, padding=None):
    return nn.Conv2d(i, o, k, stride=stride, padding=k // 2 if padding is None else padding)


def up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


# ---------------------------------------------------------------- UNet ---- #
class ResBlock(nn.Module):
    def __init__(self, i, o, emb):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(i), nn.SiLU(), conv(i, o))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb, o))
        self.out_layers = nn.Sequential(GroupNorm(o), nn.SiLU(), nn.Identity(), conv(o, o))
        self.skip_connection = conv(i, o, 1) if i != o else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    def __init__(self, qdim, cdim, heads, dh):
        super().__init__()
        self.heads, self.dh = heads, dh
        self.to_q = nn.Linear(qdim, heads * dh, bias=False)
        self.to_k = nn.Linear(cdim, heads * dh, bias=False)
        self.to_v = nn.Linear(cdim, heads * dh, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dh, qdim), nn.Identity())

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        q = self.to_q(x).reshape(b, sq, self.heads, self.dh)
        k = self.to_k(context).reshape(b, -1, self.heads, self.dh)
        v = self.to_v(context).reshape(b, -1, self.heads, self.dh)
        return self.to_out(attention(q, k, v).reshape(b, sq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(),
                                 nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dh, cdim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dh)
        self.attn2 = CrossAttention(dim, cdim, heads, dh)
        self.ff = FeedForward(dim)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch, dh, cdim, depth):
        super().__init__()
        self.norm = GroupNorm(ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, ch // dh, dh, cdim) for _ in range(depth))
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        b, c, h, w = x.shape
        seq = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            seq = blk(seq, context)
        return self.proj_out(seq).transpose(1, 2).reshape(b, c, h, w) + x


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = conv(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = conv(ch, ch)

    def forward(self, x):
        return self.conv(up2(x))


class Block(nn.ModuleList):
    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class Encoder(nn.Module):
    """time_embed + input_blocks + middle_block (UNet and ControlNet)."""

    def __init__(self, in_channels, model_channels=320, num_res_blocks=2,
                 attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                 num_head_channels=64, transformer_depth=1, context_dim=1024):
        super().__init__()
        mc, ted = model_channels, model_channels * 4
        self.mc = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        self.st = lambda ch: SpatialTransformer(ch, num_head_channels, context_dim,
                                                transformer_depth)
        self.input_blocks = nn.ModuleList([Block([conv(in_channels, mc)])])
        self.chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(self.st(ch))
                self.input_blocks.append(Block(layers))
                self.chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Block([Downsample(ch)]))
                self.chans.append(ch)
                ds *= 2
        self.middle_block = Block([ResBlock(ch, ch, ted), self.st(ch), ResBlock(ch, ch, ted)])
        self.ds, self.ted = ds, ted

    def embed(self, t):
        return self.time_embed(timestep_embedding(t, self.mc))


class UNetModel(Encoder):
    def __init__(self, in_channels=4, out_channels=4, **kw):
        super().__init__(in_channels, **kw)
        mc, ted = self.mc, self.ted
        nrb = kw.get("num_res_blocks", 2)
        att = kw.get("attention_resolutions", (4, 2, 1))
        ch, ds, skips = self.chans[-1], self.ds, list(self.chans)
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(kw.get("channel_mult", (1, 2, 4, 4))))):
            for i in range(nrb + 1):
                layers = [ResBlock(ch + skips.pop(), mc * mult, ted)]
                ch = mc * mult
                if ds in att:
                    layers.append(self.st(ch))
                if level and i == nrb:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Block(layers))
        self.out = nn.Sequential(GroupNorm(ch), nn.SiLU(), conv(ch, out_channels))

    def forward(self, x, t, context, control):
        emb = self.embed(t)
        hs, h = [], x
        for blk in self.input_blocks:
            h = blk(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context) + control[-1]
        for blk in self.output_blocks:
            skip = hs.pop() + control[len(hs)]
            h = blk(torch.cat([h, skip], dim=1), emb, context)
        return self.out(h)


class ControlNet(Encoder):
    def __init__(self, in_channels=4, hint_channels=4, **kw):
        super().__init__(in_channels + hint_channels, **kw)
        self.zero_convs = nn.ModuleList(nn.Sequential(conv(c, c, 1)) for c in self.chans)
        self.middle_block_out = nn.Sequential(conv(self.chans[-1], self.chans[-1], 1))

    def forward(self, x, hint, t, context):
        emb = self.embed(t)
        h, outs = torch.cat([x, hint], dim=1), []
        for blk, zc in zip(self.input_blocks, self.zero_convs):
            h = blk(h, emb, context)
            outs.append(zc(h))
        outs.append(self.middle_block_out(self.middle_block(h, emb, context)))
        return outs


# ----------------------------------------------------------------- VAE ---- #
class ResnetBlock(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(i, 1e-6), conv(i, o)
        self.norm2, self.conv2 = GroupNorm(o, 1e-6), conv(o, o)
        if i != o:
            self.nin_shortcut = conv(i, o, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(ch, 1e-6)
        self.q, self.k, self.v, self.proj_out = (conv(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).flatten(2).transpose(1, 2).reshape(b, h * w, 1, c)
                   for m in (self.q, self.k, self.v))
        out = attention(q, k, v).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class VAEDown(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = conv(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Level(nn.Module):
    def __init__(self, i, o, n, resample):
        super().__init__()
        self.block = nn.ModuleList(ResnetBlock(i if j == 0 else o, o) for j in range(n))
        self.resample = {"down": "downsample", "up": "upsample"}.get(resample)
        if resample is not None:
            setattr(self, self.resample, VAEDown(o) if resample == "down" else Upsample(o))

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        return x if self.resample is None else getattr(self, self.resample)(x)


class Mid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = ResnetBlock(ch, ch), AttnBlock(ch), \
            ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VAEEncoder(nn.Module):
    def __init__(self, ch, ch_mult, nrb, z):
        super().__init__()
        chans = [ch] + [ch * m for m in ch_mult]
        self.conv_in = conv(3, ch)
        self.down = nn.ModuleList(
            Level(chans[i], chans[i + 1], nrb, "down" if i != len(ch_mult) - 1 else None)
            for i in range(len(ch_mult)))
        self.mid = Mid(chans[-1])
        self.norm_out = GroupNorm(chans[-1], 1e-6)
        self.conv_out = conv(chans[-1], 2 * z)

    def forward(self, x):
        h = self.conv_in(x)
        for lv in self.down:
            h = lv(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class VAEDecoder(nn.Module):
    def __init__(self, ch, ch_mult, nrb, z):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = conv(z, c)
        self.mid = Mid(c)
        levels = {}
        for i in reversed(range(len(ch_mult))):
            levels[i] = Level(c, ch * ch_mult[i], nrb + 1, "up" if i != 0 else None)
            c = ch * ch_mult[i]
        self.up = nn.ModuleList(levels[i] for i in range(len(ch_mult)))
        self.norm_out = GroupNorm(c, 1e-6)
        self.conv_out = conv(c, 3)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for lv in reversed(self.up):
            h = lv(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4,
                 embed_dim=4):
        super().__init__()
        self.encoder = VAEEncoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = VAEDecoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = conv(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = conv(embed_dim, z_channels, 1)

    def moments(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)


# ---------------------------------------------------------------- CLIP ---- #
class MHA(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        b, s, d = x.shape
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        return self.out_proj(attention(q, k, v, mask=mask).reshape(b, s, d))


class CLIPBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_1, self.ln_2 = nn.LayerNorm(width), nn.LayerNorm(width)
        self.attn = MHA(width, heads)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width),
                                  "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp["c_proj"](F.gelu(self.mlp["c_fc"](self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    """Penultimate-layer features: ``layers - 1`` blocks, then ``ln_final``."""

    def __init__(self, vocab_size=49408, context_length=77, width=1024, heads=16, layers=24):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(CLIPBlock(width, heads)
                                                   for _ in range(layers - 1))
        self.ln_final = nn.LayerNorm(width)

    def forward(self, tokens):
        x = self.token_embedding(tokens) + self.positional_embedding
        s = tokens.shape[-1]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        return self.ln_final(x)


# -------------------------------------------------------------- SwinIR ---- #
RGB_MEAN = (0.4488, 0.4371, 0.4040)


@functools.lru_cache(maxsize=8)
def rel_index(window):
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


@functools.lru_cache(maxsize=8)
def shift_mask(h, w, window, shift):
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim, window, heads):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2,
                                                                     heads))
        self.qkv, self.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)

    def forward(self, x, mask):
        bnw, n, c = x.shape
        q, k, v = (t.reshape(bnw, n, self.heads, -1) for t in self.qkv(x).chunk(3, -1))
        idx = torch.as_tensor(rel_index(self.window).reshape(-1), device=x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)[None]
        if mask is not None:
            m = torch.as_tensor(mask, device=x.device)[:, None]
            bias = bias + m.repeat(bnw // mask.shape[0], 1, 1, 1)
        return self.proj(attention(q, k, v, bias=bias).reshape(bnw, n, -1))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1, self.norm2 = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        hid = int(dim * mlp_ratio)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(dim, hid), "fc2": nn.Linear(hid, dim)})

    def forward(self, x, hw):
        h, w = hw
        b, l, c = x.shape
        win, shift = self.window, self.shift if min(h, w) > self.window else 0
        y = self.norm1(x).reshape(b, h, w, c)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = y.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attn(y.reshape(-1, win * win, c), shift_mask(h, w, win, shift) if shift
                      else None)
        y = y.reshape(b, h // win, w // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, h, w, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y.reshape(b, l, c)
        return x + self.mlp["fc2"](F.gelu(self.mlp["fc1"](self.norm2(x))))


class RSTB(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio):
        super().__init__()
        self.residual_group = nn.Module()
        self.residual_group.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio)
            for j in range(depth))
        self.conv = conv(dim, dim)

    def forward(self, x, hw):
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x, hw)
        b, l, c = x.shape
        return self.conv(x.transpose(1, 2).reshape(b, c, *hw)).flatten(2).transpose(1, 2) + res


class SwinIR(nn.Module):
    """The realesrgan head: x8 pixel unshuffle, nearest+conv x8 upsampler,
    [0, 1] NHWC in and out."""

    SCALE = 8

    def __init__(self, embed_dim=180, depths=(6,) * 8, num_heads=(6,) * 8, window_size=8,
                 mlp_ratio=2.0):
        super().__init__()
        s = self.SCALE
        self.window = window_size
        self.conv_first = nn.Sequential(nn.PixelUnshuffle(s), conv(3 * s * s, embed_dim))
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(embed_dim)
        self.layers = nn.ModuleList(RSTB(embed_dim, d, h, window_size, mlp_ratio)
                                    for d, h in zip(depths, num_heads))
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = conv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(conv(embed_dim, 64))
        self.conv_up1, self.conv_up2, self.conv_up3, self.conv_hr = (conv(64, 64)
                                                                     for _ in range(4))
        self.conv_last = conv(64, 3)

    def forward(self, x):
        b, h0, w0, _ = x.shape
        x = x.permute(0, 3, 1, 2)
        mult = self.window * self.SCALE
        ph, pw = (-h0) % mult, (-w0) % mult
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect" if ph < h0 and pw < w0 else "replicate")
        mean = torch.tensor(RGB_MEAN, device=x.device).reshape(1, 3, 1, 1)
        feat = self.conv_first(x - mean)
        _, c, hh, ww = feat.shape
        seq = self.patch_embed.norm(feat.flatten(2).transpose(1, 2))
        for layer in self.layers:
            seq = layer(seq, (hh, ww))
        feat = self.conv_after_body(self.norm(seq).transpose(1, 2).reshape(b, c, hh, ww)) + feat
        y = F.leaky_relu(self.conv_before_upsample(feat), 0.01)
        for up in (self.conv_up1, self.conv_up2, self.conv_up3):
            y = F.leaky_relu(up(up2(y)), 0.2)
        y = self.conv_last(F.leaky_relu(self.conv_hr(y), 0.2)) + mean
        return y[:, :, :h0, :w0].permute(0, 2, 3, 1)


# ---------------------------------------------------------- ControlLDM ---- #
class ControlLDM(nn.Module):
    scale_factor = 0.18215

    def __init__(self, unet: dict, controlnet: dict, vae: dict, clip: dict):
        super().__init__()
        self.unet = UNetModel(**unet)
        self.vae = AutoencoderKL(**vae)
        self.clip = CLIPTextEncoder(**clip)
        self.controlnet = ControlNet(**controlnet)

    def forward(self, x, t, c_txt, c_img):
        """x, c_img NHWC latents; t [B] float; -> NHWC model output (control
        scale 1, as served and trained)."""
        xn = x.permute(0, 3, 1, 2)
        control = self.controlnet(xn, c_img.permute(0, 3, 1, 2), t, c_txt)
        return self.unet(xn, t, c_txt, control).permute(0, 2, 3, 1)

    def encode(self, image, eps: Optional[torch.Tensor] = None):
        """image [-1, 1] NHWC -> scaled latent NHWC (posterior mean, or a
        sample with ``eps``)."""
        mean, logvar = self.vae.moments(image.permute(0, 3, 1, 2))
        if eps is not None:
            mean = mean + torch.exp(0.5 * logvar) * eps.permute(0, 3, 1, 2)
        return (mean * self.scale_factor).permute(0, 2, 3, 1)

    def decode(self, z):
        zn = z.permute(0, 3, 1, 2) / self.scale_factor
        return self.vae.decoder(self.vae.post_quant_conv(zn)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def controlnet_from_unet_(self):
        """The ControlNet's shared keys copied from the UNet; the input conv's
        hint channels zero; the zero convs kept."""
        unet = self.unet.state_dict()
        for key, p in self.controlnet.state_dict().items():
            src = unet.get(key)
            if src is None:
                continue
            if src.shape == p.shape:
                p.copy_(src)
            else:
                p.zero_()
                p[:, :src.shape[1]].copy_(src)


def build(kind: str, sizes: dict) -> nn.Module:
    """The reference network of ``kind`` ("cldm" or "swinir") at ``sizes``
    (a configuration file's group of that name)."""
    if kind == "cldm":
        return ControlLDM(sizes["unet"], sizes["controlnet"], sizes["vae"], sizes["clip"])
    if kind == "swinir":
        return SwinIR(**sizes)
    raise ValueError(f"unknown network {kind!r}")

