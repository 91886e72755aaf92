"""LLaVA-1.5: the CLIP ViT-L/14-336 vision tower, the MLP projector and the
Llama decoder with KV-cache greedy decoding.

Counterpart of ``diffbir_tpu/models/llava.py``. Module attributes are the
keys of the HF ``llava-hf/llava-1.5-7b-hf`` checkpoint
(``language_model.model.layers.{i}.self_attn.q_proj``,
``language_model.lm_head``, ``vision_tower.vision_model.encoder.layers.{i}``,
``multi_modal_projector.linear_1``), so a real checkpoint can load without
renaming; ``weights/convert.py::llava_to_state_dict`` maps the JAX package's
functional trees onto them.

Precision: every float leaf shares one dtype (bf16 on the card, fp32 in the
tests); the JAX trees mix fp16/fp32/bf16 leaves and let type promotion pick
the activation dtype, which is not reproduced. RMSNorm and LayerNorm take
fp32 statistics; RoPE angles are fp32 positions times fp32 inverse
frequencies, as in JAX; attention logits and softmax are fp32.

Dispatch: the vision tower's unmasked self-attention goes through
``ops.attention.attention`` (K1 on the card for head dim 64); the Llama's
attention carries a causal mask or reads a cache slice, so it runs the plain
math. ``quantize_llama_`` puts the 7 big linears of every decoder layer on
K5 (packed int4) or K4 (int8); ``lm_head`` stays float.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.quant_matmul import INT4_WINDOW, Int4Linear, QuantLinear
from ..utils.common import StageClock
from .layers import Conv2d, LayerNormFp32, dense

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


# --------------------------------------------------------------------------- #
# configs (the JAX package's)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    ffn_dim: int = 11008
    vocab_size: int = 32000
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(dim=64, n_layers=2, n_heads=4, ffn_dim=128, vocab_size=256,
                   max_seq_len=64)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    norm_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls) -> "ClipVisionConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=2, heads=4,
                   mlp_dim=64)


# --------------------------------------------------------------------------- #
# Llama decoder
# --------------------------------------------------------------------------- #
class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) in fp32, rounded to x's dtype, then times
    the weight (``_rms_norm``)."""

    def __init__(self, dim: int, eps: float, dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight.to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """fp32 (cos, sin) [T, head_dim] of HF Llama's concatenated [ang, ang]
    rotary angles (``_rope``): fp32 positions times fp32 inverse
    frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.float()[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, Dh] rotated (rotate_half over the Dh/2 split), in fp32,
    cast back to x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.n_heads, self.head_dim = cfg.n_heads, cfg.head_dim
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, dense(cfg.dim, cfg.dim, bias=False, dtype=dtype, device=device))

    def forward(self, h, cos, sin, cache, pos: int, mask: Optional[torch.Tensor]):
        """h [B, T, D] at positions pos..pos+T-1; writes k and v into the
        cache in place and attends over its first pos + T rows."""
        b, t, d = h.shape
        shape = (b, t, self.n_heads, self.head_dim)
        q = apply_rope(self.q_proj(h).reshape(shape), cos, sin)
        k = apply_rope(self.k_proj(h).reshape(shape), cos, sin)
        v = self.v_proj(h).reshape(shape)
        k_cache, v_cache = cache
        k_cache[:, pos:pos + t] = k
        v_cache[:, pos:pos + t] = v
        att = attention(q, k_cache[:, :pos + t], v_cache[:, :pos + t], bias=mask, impl="plain")
        return self.o_proj(att.reshape(b, t, d))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.gate_proj = dense(cfg.dim, cfg.ffn_dim, bias=False, dtype=dtype, device=device)
        self.up_proj = dense(cfg.dim, cfg.ffn_dim, bias=False, dtype=dtype, device=device)
        self.down_proj = dense(cfg.ffn_dim, cfg.dim, bias=False, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaDecoderLayer(nn.Module):
    """``llama_block``: pre-RMSNorm attention and SwiGLU MLP, residuals."""

    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, dtype, device)
        self.self_attn = LlamaAttention(cfg, dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps, dtype, device)
        self.mlp = LlamaMLP(cfg, dtype, device)

    def forward(self, x, cos, sin, cache, pos: int, mask):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, cache, pos, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=dtype, device=device)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, dtype, device)


def causal_bias(t: int, device) -> torch.Tensor:
    """[1, 1, T, T] additive mask: 0 on and below the diagonal, -1e9 above."""
    keep = torch.ones(t, t, dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, -1e9)[None, None].float()


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, dtype, device)
        self.lm_head = dense(cfg.dim, cfg.vocab_size, bias=False, dtype=dtype, device=device)

    def new_cache(self, batch: int, length: int, dtype, device) -> KVCache:
        """Zeroed k and v caches [B, length, H, Dh] for every layer."""
        shape = (batch, length, self.cfg.n_heads, self.cfg.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(self.cfg.n_layers)]

    def hidden(self, x: torch.Tensor, pos: int, cache: KVCache,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder on x [B, T, D] at positions pos..pos+T-1, then the
        final norm; the caches are written in place."""
        cos, sin = rope_tables(torch.arange(pos, pos + x.shape[1], device=x.device),
                               self.cfg.head_dim, self.cfg.rope_theta)
        for layer, layer_cache in zip(self.model.layers, cache):
            x = layer(x, cos, sin, layer_cache, pos, mask)
        return self.model.norm(x)

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        """Logits [B, T, V] at every position of a causal pass over embeds."""
        b, t, _ = embeds.shape
        cache = self.new_cache(b, t, embeds.dtype, embeds.device)
        return self.lm_head(self.hidden(embeds, 0, cache, causal_bias(t, embeds.device)))

    def prefill(self, embeds: torch.Tensor, cache_len: int):
        """embeds [B, T, D] -> (last-position logits [B, V], caches of
        cache_len rows holding the prompt's k and v) (``llama_prefill``)."""
        b, t, _ = embeds.shape
        cache = self.new_cache(b, cache_len, embeds.dtype, embeds.device)
        h = self.hidden(embeds, 0, cache, causal_bias(t, embeds.device))
        return self.lm_head(h[:, -1]), cache

    def decode_step(self, token: torch.Tensor, pos: int, cache: KVCache) -> torch.Tensor:
        """token [B] at position pos -> logits [B, V]; k and v written into
        the caches at pos (``llama_decode_step``)."""
        x = self.model.embed_tokens(token)[:, None]
        return self.lm_head(self.hidden(x, pos, cache, None)[:, 0])

    @torch.no_grad()
    def greedy_decode(self, prompt_embeds: torch.Tensor, max_new_tokens: int, eos_id: int,
                      timings: Optional[Dict[str, float]] = None,
                      step_logits: Optional[list] = None) -> torch.Tensor:
        """Prefill, then cached decode steps: [B, max_new_tokens] token ids,
        each row padded with eos_id after its first EOS (``greedy_decode``).
        The tokens are JAX's; two steps are skipped, since their outputs are
        never used: the last decode step (JAX computes and discards its
        logits), and every step once all rows have emitted EOS.

        ``timings`` gets the seconds of "prefill" and "decode" and the
        number of "decode_steps"; ``step_logits`` gets the logits [B, V]
        each token was chosen from."""
        clock = StageClock(timings, prompt_embeds.device, "caption")
        b, t0, _ = prompt_embeds.shape
        logits, cache = self.prefill(prompt_embeds, t0 + max_new_tokens)
        token = logits.argmax(dim=-1)
        clock.lap("prefill")
        done = torch.zeros(b, dtype=torch.bool, device=token.device)
        out = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=token.device)
        steps = 0
        for i in range(max_new_tokens):
            if step_logits is not None:
                step_logits.append(logits)
            out[:, i] = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
            if i == max_new_tokens - 1 or bool(done.all()):
                break
            logits = self.decode_step(token, t0 + i, cache)
            token = logits.argmax(dim=-1)
            steps += 1
        clock.lap("decode")
        clock.finish()
        if timings is not None:
            timings["decode_steps"] = steps
        return out


# --------------------------------------------------------------------------- #
# CLIP ViT vision tower (HF CLIPVisionModel layout) and projector
# --------------------------------------------------------------------------- #
def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.heads = cfg.heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, dense(cfg.width, cfg.width, dtype=dtype, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        shape = (b, t, self.heads, d // self.heads)
        q, k, v = (p(h).reshape(shape) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v).reshape(b, t, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.fc1 = dense(cfg.width, cfg.mlp_dim, dtype=dtype, device=device)
        self.fc2 = dense(cfg.mlp_dim, cfg.width, dtype=dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(h)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.layer_norm1 = LayerNormFp32(cfg.width, cfg.norm_eps, device, dtype)
        self.self_attn = CLIPAttention(cfg, dtype, device)
        self.layer_norm2 = LayerNormFp32(cfg.width, cfg.norm_eps, device, dtype)
        self.mlp = CLIPMLP(cfg, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width, dtype=dtype, device=device))
        self.patch_embedding = Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                                      bias=False, dtype=dtype, device=device)
        self.position_embedding = nn.Embedding(cfg.n_patches + 1, cfg.width, dtype=dtype,
                                               device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3] -> [B, 1 + patches, W] (CLS first)."""
        patches = self.patch_embedding(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight.to(patches.dtype)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype, device=None):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg, dtype, device)
        self.pre_layrnorm = LayerNormFp32(cfg.width, cfg.norm_eps, device, dtype)
        self.encoder = CLIPEncoder(cfg, dtype, device)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: ClipVisionConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg, dtype, device)

    def forward(self, images: torch.Tensor, select_layer: int = -2) -> torch.Tensor:
        """images [B, S, S, 3] (CLIP-normalised) -> patch features [B, P, W]
        of the ``select_layer`` hidden state, CLS dropped
        (``clip_vision_features``): the first layers + select_layer + 1
        layers run."""
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(images))
        n_keep = self.cfg.layers + select_layer + 1 if select_layer < 0 else select_layer
        for layer in vm.encoder.layers[:n_keep]:
            x = layer(x)
        return x[:, 1:]


class LlavaMultiModalProjector(nn.Module):
    """linear -> exact-erf GELU -> linear (``project_image_features``)."""

    def __init__(self, in_dim: int, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.linear_1 = dense(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = dense(dim, dim, dtype=dtype, device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(feats)))


class Llava(nn.Module):
    """The LLaVA-1.5 model: ``vision_tower``, ``multi_modal_projector`` and
    ``language_model``."""

    def __init__(self, cfg: LlamaConfig, vcfg: ClipVisionConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg, self.vcfg = cfg, vcfg
        self.vision_tower = CLIPVisionModel(vcfg, dtype, device)
        self.multi_modal_projector = LlavaMultiModalProjector(vcfg.width, cfg.dim, dtype, device)
        self.language_model = LlamaForCausalLM(cfg, dtype, device)

    @classmethod
    def llava15_7b(cls, dtype=torch.bfloat16, device=None) -> "Llava":
        """LLaVA-1.5-7B (``llava-hf/llava-1.5-7b-hf``): CLIP ViT-L/14 at 336 px
        and Llama-7B."""
        return cls(LlamaConfig(), ClipVisionConfig(), dtype, device)

    def image_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3] -> projected patch embeddings [B, P, D]."""
        return self.multi_modal_projector(self.vision_tower(images))


QUANT_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@torch.no_grad()
def quantize_llama_(model: Llava, bits: int) -> Llava:
    """Replace the 7 big linears of every decoder layer (``QUANT_KEYS``) in
    place, quantised from their current weights: bits=4 -> ``Int4Linear``
    (K5) where in_features % 256 == 0, else ``QuantLinear`` (K4), as the JAX
    ``quantize_llama_params`` does; bits=8 -> ``QuantLinear``. Embeddings,
    norms and ``lm_head`` stay float (bitsandbytes skips lm_head)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for layer in model.language_model.model.layers:
        for parent in (layer.self_attn, layer.mlp):
            for name, lin in list(parent.named_children()):
                if name not in QUANT_KEYS:
                    continue
                if bits == 4 and lin.in_features % INT4_WINDOW == 0:
                    setattr(parent, name, Int4Linear.from_linear(lin))
                else:
                    setattr(parent, name, QuantLinear.from_linear(lin))
    return model
