"""Attention entry point: plain torch math, or the flash kernel (K1).

Counterpart of ``diffbir_tpu/ops/attention.py``. Layout: q [B, Sq, H, D];
k, v [B, Skv, H, D]; returns [B, Sq, H, D]. Logits and softmax are fp32
whatever the input dtype, and the probabilities are cast to the input dtype
before the PV product.

Dispatch: every self-attention call (Skv == Sq) without mask or bias and with
d in {64, 128, 256, 512} goes to ``flash_attention`` (the CUDA kernel for a
CUDA tensor, its plain version for a CPU tensor). Everything else is plain
math: cross-attention to the 77 text tokens, SwinIR window attention (bias and
shift mask) and CLIP causal attention. The TPU dispatch thresholds are not
carried over; the port sets its own from H100 measurements.
"""

from __future__ import annotations

from typing import Optional

import torch

FLASH_HEAD_DIMS = (64, 128, 256, 512)


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Einsum attention with fp32 logits and softmax (float64 inputs stay
    float64, so the CPU path can be gradient-checked).

    mask: broadcastable to [B, H, Sq, Skv], True = keep.
    bias: broadcastable additive bias (e.g. Swin relative position bias).
    """
    orig_dtype = q.dtype
    acc = torch.promote_types(orig_dtype, torch.float32)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc) * scale, k.to(acc))
    if bias is not None:
        logits = logits + bias.to(acc)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(acc).min)
    weights = logits.softmax(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(orig_dtype), v)
    return out.to(orig_dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatching attention used by all models. ``impl``: "auto" (flash
    where the call qualifies) or "plain" (always the plain math)."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    flash = (
        impl == "auto" and mask is None and bias is None
        and k.shape[1] == q.shape[1] and q.shape[-1] in FLASH_HEAD_DIMS
    )
    if not flash:
        return plain_attention(q, k, v, mask=mask, bias=bias)
    from .flash_attention import flash_attention

    return flash_attention(q, k, v)
