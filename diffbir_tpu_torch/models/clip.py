"""OpenCLIP ViT-H/14 text tower (frozen prompt encoder), [B, S, D].

Counterpart of ``diffbir_tpu/models/clip.py``: pre-LN blocks with packed-qkv
multi-head attention under a causal mask, exact-GELU MLP, penultimate-layer
features (``layers - 1`` blocks, then ``ln_final``). Only the blocks that run
are built, as in the JAX param tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .layers import LayerNormFp32, dense


class _MHA(nn.Module):
    """Packed-qkv self-attention in torch ``nn.MultiheadAttention`` layout."""

    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, dtype=dtype, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, dtype=dtype, device=device))
        self.out_proj = dense(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, self.heads, d // self.heads) for t in qkv.chunk(3, dim=-1))
        out = attention(q, k, v, mask=causal_mask).reshape(b, s, d)
        return self.out_proj(out)


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        self.ln_1 = LayerNormFp32(width, device=device)
        self.attn = _MHA(width, heads, dtype, device)
        self.ln_2 = LayerNormFp32(width, device=device)
        self.mlp = nn.ModuleDict({
            "c_fc": dense(width, width * 4, dtype=dtype, device=device),
            "c_proj": dense(width * 4, width, dtype=dtype, device=device),
        })

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal_mask)
        h = F.gelu(self.mlp["c_fc"](self.ln_2(x)))  # exact erf GELU
        return x + self.mlp["c_proj"](h)


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, n_blocks: int, dtype, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            _ResBlock(width, heads, dtype, device) for _ in range(n_blocks))


class CLIPTextEncoder(nn.Module):
    """Per-token features [B, 77, width] for cross-attention conditioning."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 1024, heads: int = 16, layers: int = 24,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.context_length = context_length
        self.width = width
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=dtype, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width, device=device))
        self.transformer = _Transformer(width, heads, layers - 1, dtype, device)
        self.ln_final = LayerNormFp32(width, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.shape[-1] != self.context_length:
            raise ValueError(f"expected {self.context_length} tokens, got {tokens.shape[-1]}")
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding.to(x.dtype)
        s = self.context_length
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        for block in self.transformer.resblocks:
            x = block(x, causal)
        return self.ln_final(x)
