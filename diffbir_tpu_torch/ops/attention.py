"""Attention entry point: plain torch math, or the flash kernel (K1).

Counterpart of ``diffbir_tpu/ops/attention.py``. Layout: q [B, Sq, H, D];
k, v [B, Skv, H, D]; returns [B, Sq, H, D]. Logits and softmax are fp32
whatever the input dtype, and the probabilities are cast to the input dtype
before the PV product.

Dispatch: every self-attention call (Skv == Sq, or a spatially sharded one
whose caller says ``kv_gathered``) without mask or bias and with d in {64,
128, 256} goes to ``flash_attention`` (the CUDA kernels for a CUDA
tensor, their plain version for a CPU tensor). The wide single-head sites
(d > 256: the VAE's d = 512 mid-block attention) go to flash from
``FLASH_MIN_WIDE`` = 4096 tokens (a 512x512 image), and to plain math below
it. The reference sends them to flash from 8192 tokens
(``diffbir_tpu/ops/attention.py:86-96``, ``DIFFBIR_TPU_FLASH_MIN_WIDE``), a
threshold set on a TPU for memory; the port's is the card's reading: on an
NVIDIA H100 80GB HBM3 at a 700 W power limit, flash's d = 512 tensor-core
entry took 0.330 ms against 0.589 ms for the plain version at
[1,4096,1,512], 1.279 against 4.071 at [8,4096,1,512], 0.640 against 2.035
at [1,8192,1,512] and 2.224 against 7.508 at [1,16384,1,512]
(``chip_smoke.py``, which times both at these shapes). 4096 is the smaller
of the two thresholds considered, 4096 and 8192, at which flash wins there
and at every larger size measured.

Under a gradient (RGB guidance differentiates through the VAE decoder) the
backward decides too. In bf16 at d = 512 it runs the wide tensor-core
K2a/K2b after a delta pre-pass. On the same card, one forward plus backward
through K1_wide + delta + K2a_wide + K2b_wide took 1.16-1.20 ms against
1.70-2.13 ms for the plain version under autograd at [1,4096,1,512],
3.16-3.20 against 5.60-5.64 at [1,8192,1,512] and 12.32-12.44 against
22.13-22.35 at [1,16384,1,512] (SDPA 6.86-7.15, 19.49-20.00 and
69.71-72.56 ms; two runs of ``chip_smoke.py``'s ``[d512_backward]``, which
times all three). So such a call goes to flash from
``FLASH_MIN_WIDE_GRAD`` = 4096 tokens, the smallest of 4096, 8192 and
16384 at which flash wins there and at every larger size measured; plain's
peak above the inputs grows as the square of the tokens (0.27 GiB at 4096,
4.09 GiB at 16384). The JAX package sends d = 512 to flash from 8192
tokens with or without a gradient. Before the wide backward, the d = 512
backward ran on CUDA-core kernels (forward plus backward 15.70 ms at 4096
tokens, 365.70 ms at 16384), and this threshold was 65536.
``layout="packed"`` (the JAX package's ``DIFFBIR_TPU_FLASH_LAYOUT=packed``)
runs the flash calls through K3, K1 with q pre-scaled once in bf16, where
the JAX packed kernel runs: a forward without gradient and Sq <= 1024 or
Sq % 1024 == 0.
Everything else is plain math: cross-attention to the 77 text tokens,
SwinIR window attention (bias and shift mask) and CLIP causal attention.
The TPU's other dispatch threshold (flash only from 2048 tokens) is not
carried over; the port sets its own from H100 measurements.

Both d > 256 thresholds and the packed rule count the whole image's
tokens: Skv, which under ``kv_gathered`` is every band's and Sq only this
band's. So a band of a spatially sharded model takes the route that the
same image takes in one process (the 1024x1024 image's VAE mid-block on
two processes: [1,8192,1,512] queries against 16384 gathered kv rows, on
K1_wide; a band of 1536 queries of a 3072-token image in the packed
layout, on K3, as the JAX packed kernel takes the whole image's gathered
queries).
"""

from __future__ import annotations

from typing import Optional

import torch

FLASH_HEAD_DIMS = (64, 128, 256, 512)
FLASH_LAYOUTS = ("folded", "packed")
# tokens from which a d > 256 self-attention goes to flash (see above)
FLASH_MIN_WIDE = 4096
# the same under a gradient (see above: the backward's reading)
FLASH_MIN_WIDE_GRAD = 4096


def packed_applies(sq: int) -> bool:
    """Whether the JAX packed kernel takes Sq query rows: one 1024-row q
    block or whole ones (``_flash_attention_impl_packed`` sends the rest to
    the folded kernel)."""
    return sq <= 1024 or sq % 1024 == 0


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Einsum attention with fp32 logits and softmax (float64 inputs stay
    float64, so the CPU path can be gradient-checked).

    mask: broadcastable to [B, H, Sq, Skv], True = keep.
    bias: broadcastable additive bias (e.g. Swin relative position bias).
    scale: the logits' scale, d^-1/2 by default.
    """
    orig_dtype = q.dtype
    acc = torch.promote_types(orig_dtype, torch.float32)
    if scale is None:
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
    layout: str = "folded",
    kv_gathered: bool = False,
) -> torch.Tensor:
    """Dispatching attention used by all models. ``impl``: "auto" (flash
    where the call qualifies; d > 256 from ``FLASH_MIN_WIDE`` tokens, or
    from ``FLASH_MIN_WIDE_GRAD`` where autograd records a gradient of q, k
    or v) or "plain" (always the plain math).
    ``layout``: "folded" (K1) or "packed" (K3 where it applies, see above).
    ``kv_gathered``: k and v are a self-attention's keys gathered over the
    bands of a spatially sharded image, whose queries q are one band
    (``parallel/inference.py``): the call takes the self-attention rule
    although Skv != Sq, and the d > 256 thresholds read Skv, the whole
    image's tokens, as the packed rule does. Cross-attention (Skv != Sq,
    not gathered) keeps the plain math."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if layout not in FLASH_LAYOUTS:
        raise ValueError(f"unknown flash layout {layout!r}")
    d, sq, skv = q.shape[-1], q.shape[1], k.shape[1]
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    flash = (
        impl == "auto" and mask is None and bias is None
        and (skv == sq or kv_gathered) and d in FLASH_HEAD_DIMS
        and (d <= 256 or skv >= (FLASH_MIN_WIDE_GRAD if grad else FLASH_MIN_WIDE))
    )
    if not flash:
        return plain_attention(q, k, v, mask=mask, bias=bias)
    from .flash_attention import flash_attention

    if layout == "packed" and packed_applies(skv if kv_gathered else sq):
        return flash_attention(q, k, v, prescale_q=True)
    return flash_attention(q, k, v)
