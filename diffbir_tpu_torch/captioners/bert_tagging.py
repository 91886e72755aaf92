"""BERT-style tagging head: RAM++'s query2label alignment decoder.

Counterpart of ``diffbir_tpu/captioners/bert_tagging.py``: each layer is
cross-attention (the label queries attend to the image embeddings; no
self-attention, as in RAM++'s "tagging" mode) with its output projection
and a residual LayerNorm, then the intermediate exact-erf GELU MLP and a
residual LayerNorm; LayerNorm eps 1e-12. The attention is plain math, as it
is XLA's in JAX (no flash kernel). Key names are RAM++'s:
``encoder.layer.{i}.crossattention.self.query`` and so on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import LayerNormFp32, dense
from ..ops.attention import plain_attention

BERT_EPS = 1e-12


class TaggingLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int, enc_width: int, dtype,
                 device=None):
        super().__init__()
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.crossattention = nn.ModuleDict({
            "self": nn.ModuleDict({"query": dense(hidden, hidden, **kw),
                                   "key": dense(enc_width, hidden, **kw),
                                   "value": dense(enc_width, hidden, **kw)}),
            "output": nn.ModuleDict({"dense": dense(hidden, hidden, **kw),
                                     "LayerNorm": LayerNormFp32(hidden, BERT_EPS, device)}),
        })
        self.intermediate = nn.ModuleDict({"dense": dense(hidden, intermediate, **kw)})
        self.output = nn.ModuleDict({"dense": dense(intermediate, hidden, **kw),
                                     "LayerNorm": LayerNormFp32(hidden, BERT_EPS, device)})

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        att, out = self.crossattention["self"], self.crossattention["output"]
        b, sq, c = x.shape
        dh = c // self.heads
        q = att["query"](x).reshape(b, sq, self.heads, dh)
        k = att["key"](enc).reshape(b, enc.shape[1], self.heads, dh)
        v = att["value"](enc).reshape(b, enc.shape[1], self.heads, dh)
        a = plain_attention(q, k, v).reshape(b, sq, c)
        x = out["LayerNorm"](out["dense"](a) + x)
        h = F.gelu(self.intermediate["dense"](x))  # exact erf
        return self.output["LayerNorm"](self.output["dense"](h) + x)


class TaggingHead(nn.Module):
    """``tagging_head``: [B, N, hidden] label queries, [B, L, enc_width]
    image embeddings -> [B, N, hidden]."""

    def __init__(self, hidden: int = 768, heads: int = 4, layers: int = 2,
                 intermediate: int = 3072, enc_width: int = 512, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(
            TaggingLayer(hidden, heads, intermediate, enc_width, dtype, device)
            for _ in range(layers))

    def forward(self, queries: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        x = queries
        for layer in self.encoder.layer:
            x = layer(x, enc)
        return x
