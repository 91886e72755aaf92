"""Fused ResBlock: the conv-weight quantiser, the CUDA kernel (K6), its plain
version, and the autograd Function around it.

Counterpart of ``diffbir_tpu/ops/fused_resblock.py``: K6 replaces its Pallas
TPU kernel ``_kernel`` (launched by ``_pallas_fused_resblock``) and is
``csrc/fused_resblock.cu``, built for ``sm_90a`` at first use. One call
computes a whole UNet ResBlock,

    h1  = conv3x3(SiLU(GN1(x))) + b1 + e
    out = skip(x) + conv3x3(SiLU(GN2(h1))) + b2,   skip = x or conv1x1(x) + b_skip,

in the Pallas kernel's rounding points (not those of its XLA fallback, which
adds the biases in the input dtype): the GN affine a, b in fp32, cast to the
dtype; x * a and + b each in the dtype; SiLU in fp32 and back; conv sums in
fp32, times the int8 scale when quantised, + bias + e in fp32; h1 cast to
the dtype before GN2; the skip in fp32; one final cast.

Layout, NCHW as the port's modules: x [B, Cin, H, W], e [B, Cout] (the
timestep projection). ``p`` has the JAX package's keys: gn1_scale, gn1_bias,
gn2_scale, gn2_bias; float mode w1, w2 (and w_skip) in PyTorch's OIHW layout
with b1, b2 (b_skip); int8 mode w1_q, w2_q (w_skip_q) int8 in the JAX HWIO
layout with fp32 per-output-channel scales s1, s2 (s_skip). The kernel reads
both layouts in place. Biases and e enter in x's dtype (the serving model's),
the GN affine parameters in fp32.

Every ResBlock of the model goes through K6 in the fused mode; the JAX
package's v5e dispatch tables and environment switches are not carried over.
The float mode is differentiable as in JAX (a custom VJP whose backward
recomputes the plain math); the int8 mode serves only.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import gn_fold_moments
from ._cuda import CudaKernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("fused_resblock.cu", "fused_resblock",
                    [_ptr] * 18 + [_i32] * 8 + [ctypes.c_float, _ptr])


def quantize_conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float conv kernel (..., Cout), HWIO -> (int8 of the same shape, fp32
    scale [Cout]), symmetric per output channel over the taps and Cin:
    scale = max(amax, 1e-12) / 127 (not ``quantize_weight``'s formula), round
    half to even, clip to +-127 (the JAX ``quantize_conv_weight``, bit for
    bit)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(wf.dim() - 1)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quant(p: Dict[str, torch.Tensor]) -> bool:
    return "w1_q" in p


def _has_skip(p: Dict[str, torch.Tensor]) -> bool:
    return p.get("w_skip_q" if _quant(p) else "w_skip") is not None


# --------------------------------------------------------------------------- #
# plain version
# --------------------------------------------------------------------------- #
def _silu_gn(v: torch.Tensor, scale, bias, groups: int, eps: float, acc) -> torch.Tensor:
    """SiLU(GroupNorm(v)) at the kernel's rounding points, in v's dtype."""
    dt = v.dtype
    vf = v.to(acc)
    s1 = vf.mean(dim=(2, 3))
    d = vf - s1[..., None, None]
    v_c = (d * d).mean(dim=(2, 3))
    a, b = gn_fold_moments(s1, v_c, scale.to(acc), bias.to(acc), groups, eps)
    t = v * a.to(dt)[..., None, None] + b.to(dt)[..., None, None]  # two roundings to dt
    tf = t.to(acc)
    return (tf * torch.sigmoid(tf)).to(dt)


def _conv(y: torch.Tensor, p: Dict[str, torch.Tensor], name: str, acc) -> torch.Tensor:
    """fp32 (or float64) conv sum of y with weight ``name`` (w1, w2,
    w_skip), times its int8 scale in the quantised mode."""
    quant = _quant(p)
    if quant:
        w = p[name + "_q"].to(acc).permute(3, 2, 0, 1)  # HWIO -> OIHW
    else:
        w = p[name].to(y.dtype).to(acc)
    out = F.conv2d(y.to(acc), w, padding=w.shape[-1] // 2)
    if quant:
        out = out * p[{"w1": "s1", "w2": "s2", "w_skip": "s_skip"}[name]].to(acc)[:, None, None]
    return out


def fused_resblock_ref(x: torch.Tensor, e: torch.Tensor, p: Dict[str, torch.Tensor],
                       groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K6: x [B, Cin, H, W], e [B, Cout] -> [B, Cout, H, W]
    in x's dtype (float64 stays float64, for gradient checks)."""
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)

    def vec(name):  # a bias in the dtype, per channel, in the accumulator type
        return p[name].to(dt).to(acc)[:, None, None]

    y1 = _silu_gn(x, p["gn1_scale"], p["gn1_bias"], groups, eps, acc)
    h1 = _conv(y1, p, "w1", acc) + vec("b1") + e.to(dt).to(acc)[..., None, None]
    h1 = h1.to(dt)
    y2 = _silu_gn(h1, p["gn2_scale"], p["gn2_bias"], groups, eps, acc)
    h2 = _conv(y2, p, "w2", acc) + vec("b2")
    skip = _conv(x, p, "w_skip", acc) + vec("b_skip") if _has_skip(p) else x.to(acc)
    return (skip + h2).to(dt)


# --------------------------------------------------------------------------- #
# kernel wrapper
# --------------------------------------------------------------------------- #
def _launch(x: torch.Tensor, e: torch.Tensor, p: Dict[str, torch.Tensor], groups: int,
            eps: float) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_resblock takes bf16 or fp32, got {x.dtype}")
    quant, skip = _quant(p), _has_skip(p)
    dt, dev = x.dtype, x.device
    bsz, cin, h, w = x.shape
    cout = e.shape[1]
    wdt = torch.int8 if quant else dt

    def weight(name):
        t = p[name + "_q" if quant else name]
        if t.device != dev or t.dtype != wdt:
            raise TypeError(f"fused_resblock: {name} must be {wdt} on {dev}, got "
                            f"{t.dtype} on {t.device}")
        return t.contiguous()

    def vec(name, dtype):
        return p[name].to(dev, dtype).contiguous() if name in p else None

    x = x.contiguous()
    e = e.to(dt).contiguous()
    ws = (weight("w1"), weight("w2"), weight("w_skip") if skip else None)
    scales = ((vec("s1", torch.float32), vec("s2", torch.float32),
               vec("s_skip", torch.float32) if skip else None) if quant else (None,) * 3)
    biases = (vec("b1", dt), vec("b2", dt), vec("b_skip", dt) if skip else None)
    gn = [vec(k, torch.float32) for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")]
    out = torch.empty((bsz, cout, h, w), dtype=dt, device=dev)
    h1 = torch.empty_like(out)
    stats = torch.empty(2 * bsz * (cin + cout), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        KERNEL.launch(
            ptr(x), ptr(e), ptr(gn[0]), ptr(gn[1]), ptr(ws[0]), ptr(scales[0]), ptr(biases[0]),
            ptr(gn[2]), ptr(gn[3]), ptr(ws[1]), ptr(scales[1]), ptr(biases[1]),
            ptr(ws[2]), ptr(scales[2]), ptr(biases[2]), ptr(h1), ptr(stats), ptr(out),
            _DTYPE_CODES[dt], int(quant), bsz, cin, cout, h, w, groups, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    return out


class FusedResBlock(torch.autograd.Function):
    """K6 forward (float mode); the backward differentiates the recomputed
    plain version (the JAX custom VJP's ``_diff_bwd``)."""

    @staticmethod
    def forward(ctx, x, e, names, groups, eps, *values):
        ctx.names, ctx.groups, ctx.eps = names, groups, eps
        ctx.save_for_backward(x, e, *values)
        return _launch(x, e, dict(zip(names, values)), groups, eps)

    @staticmethod
    def backward(ctx, g):
        needs = (ctx.needs_input_grad[:2] + ctx.needs_input_grad[5:])
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = fused_resblock_ref(inputs[0], inputs[1], dict(zip(ctx.names, inputs[2:])),
                                     ctx.groups, ctx.eps)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(grads) if t.requires_grad else None for t in inputs]
        return (grads[0], grads[1], None, None, None, *grads[2:])


def fused_resblock(x: torch.Tensor, e: torch.Tensor, p: Dict[str, torch.Tensor],
                   groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """One ResBlock, x [B, Cin, H, W] -> [B, Cout, H, W] (see the module's
    notes for ``p``). A CPU tensor goes to the plain version; a CUDA tensor
    launches K6 or raises. The float mode is differentiable."""
    quant = _quant(p)
    w1 = p["w1_q"] if quant else p["w1"]
    cout, cin = (w1.shape[3], w1.shape[2]) if quant else w1.shape[:2]
    if x.dim() != 4 or x.shape[1] != cin or e.shape != (x.shape[0], cout):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, e {tuple(e.shape)}, "
                         f"w1 {tuple(w1.shape)}")
    if not _has_skip(p) and cin != cout:
        raise ValueError(f"identity skip needs Cin == Cout, got {cin} -> {cout}")
    if x.device.type == "cpu":
        return fused_resblock_ref(x, e, p, groups, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_resblock: no kernel for device {x.device}")
    names = tuple(k for k, v in p.items() if v is not None)
    values = tuple(p[k] for k in names)
    if (not quant and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, e, *values))):
        return FusedResBlock.apply(x, e, names, groups, eps, *values)
    return _launch(x, e, p, groups, eps)
